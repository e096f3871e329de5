"""The port's modules against the reference fixtures, on the CPU.

Each ``tests/fixtures/*.npz`` holds a reference state dict (``sd::``), its
inputs (``in::``) and outputs (``out::``). The ``sd::`` entries load into
the port's modules with ``load_state_dict(strict=True)``, no adapter, and
the outputs match at tests/test_parity.py's tolerance (atol 2e-5, rtol
1e-5, fp32). Fuser stacks are checked twice: through the attention-weight
module path, and through the ``ops`` kernels' wrappers (their plain
versions on CPU). The predictor's rollout and attention-returning paths and
the frame-level-token T-SA-Fuser, which no fixture covers, are held against
the JAX package on the same weights.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afft_tpu.models import fusion as JF
from afft_tpu.models.predictor import BaseFuturePredictor as JaxPredictor
from afft_tpu.train import torch_import as TI
from afft_tpu_torch import weights as W
from afft_tpu_torch.models.base_model import BaseModel
from afft_tpu_torch.models.blocks import Block
from afft_tpu_torch.models.cmfp import CMFPEarly
from afft_tpu_torch.models.fusion import (CMFuser, ModalTokenCMFuser,
                                          TemporalCMFuser,
                                          TemporalCrossAttentFuser)
from afft_tpu_torch.models.mapping import LinearMapping
from afft_tpu_torch.models.predictor import BaseFuturePredictor

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
ATOL = 2e-5
RTOL = 1e-5
MODS = ["rgb", "objects", "flow"]
NUM_CLASSES = {"action": 17, "verb": 7, "noun": 9}


def load_fixture(name):
    """(state dict, inputs, outputs) of tests/fixtures/<name>.npz."""
    data = np.load(os.path.join(FIXTURES, f"{name}.npz"))
    parts = {"sd::": {}, "in::": {}, "out::": {}}
    for key in data.files:
        for prefix, part in parts.items():
            if key.startswith(prefix):
                part[key[len(prefix):]] = data[key]
    return parts["sd::"], parts["in::"], parts["out::"]


def _load(module, sd):
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                           strict=True)
    return module.eval()


def _close(got, want, name):
    got = got.detach().numpy()
    assert got.shape == want.shape, f"{name}: {got.shape} vs {want.shape}"
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)


def _inputs(ins, mods=MODS):
    return {m: torch.from_numpy(ins[m]) for m in mods}


def _check_outputs(out, outs):
    for key, want in outs.items():
        got = out
        for part in (p for p in key.split("//") if p):
            got = got[part]
        _close(got, want, key)


def _cmfp_cfg():
    """tests/test_parity.py's CMFP config (the fixtures' model)."""
    return {
        "modal_dims": {"rgb": 48, "objects": 20, "flow": 48},
        "modal_feature_order": ["rgb", "objects", "audio", "poses", "flow"],
        "dropout": 0.2,
        "common": {
            "in_features": 48, "fp_inter_dim": 64, "fp_output_len": 1,
            "share_classifiers": True, "share_predictors": True,
            "modality_cls": False, "fusion_cls": True,
        },
        "mapping": {"_target_": "models.feature_mapping.Linear",
                    "use_layernorm": False, "sparse_mapping": True},
        "fuser": {"_target_": "models.fusion.ModalTokenCMFuser", "dim": 48,
                  "depth": 2, "num_heads": 4,
                  "modalities": {"rgb": 48, "objects": 20, "flow": 48}},
        "future_predictor": {
            "_target_": "models.future_prediction.BaseFuturePredictor",
            "in_features": 48, "inter_dim": 64, "n_layer": 2, "n_head": 2,
            "embd_pdrop": 0.1, "resid_pdrop": 0.1, "attn_pdrop": 0.1,
            "output_attentions": False},
    }


@torch.no_grad()
def test_block():
    sd, ins, outs = load_fixture("block")
    blk = _load(Block(64, 4, norm_eps=1e-5), sd)  # torch default LN eps
    x = torch.from_numpy(ins["x"])
    y, attn = blk(x)
    _close(y, outs["y"], "block.y")
    _close(attn, outs["attn"], "block.attn")
    from afft_tpu_torch.ops.fused_block import fused_block
    y2 = fused_block(x, dict(blk.named_parameters()), num_heads=4, eps=1e-5)
    _close(y2, outs["y"], "block.y via fused_block")


@torch.no_grad()
def test_mapping_linear():
    sd, ins, outs = load_fixture("mapping_linear")
    mapping = _load(LinearMapping(32, 64, use_layernorm=True,
                                  sparse_mapping=False), sd)
    _close(mapping(torch.from_numpy(ins["x"])), outs["y"], "mapping.y")


@pytest.mark.parametrize("name", ["fuser_modal_token",
                                  "fuser_modal_token_variants"])
@torch.no_grad()
def test_fuser_modal_token(name):
    sd, ins, outs = load_fixture(name)
    if name == "fuser_modal_token":
        fuser = ModalTokenCMFuser(dim=64, depth=3, num_heads=4,
                                  modalities={m: 64 for m in MODS})
    else:
        fuser = ModalTokenCMFuser(dim=64, depth=2, num_heads=4,
                                  modalities={m: 64 for m in MODS},
                                  modal_encoding=True, cross_attn=True,
                                  frame_level_token=True,
                                  temporal_sequence_length=6)
    fuser = _load(fuser, sd)
    y, attn = fuser(_inputs(ins), MODS, need_weights=True)
    _close(y, outs["y"], f"{name}.y")
    _close(attn, outs["attn"], f"{name}.attn")
    y2, none = fuser(_inputs(ins), MODS)
    assert none is None
    _close(y2, outs["y"], f"{name}.y via fused_block")


@torch.no_grad()
def test_fuser_cm():
    sd, ins, outs = load_fixture("fuser_cm")
    fuser = _load(CMFuser(dim=64, depth=2, num_heads=4), sd)
    y, attn = fuser(_inputs(ins), MODS, need_weights=True)
    _close(y, outs["y"], "fuser_cm.y")
    _close(attn, outs["attn"], "fuser_cm.attn")
    y2, none = fuser(_inputs(ins), MODS)
    assert none is None
    _close(y2, outs["y"], "fuser_cm.y via fused_block")


@torch.no_grad()
def test_fuser_temporal():
    sd, ins, outs = load_fixture("fuser_temporal")
    fuser = _load(TemporalCMFuser(dim=64, depth=2, num_heads=4,
                                  modalities={m: 64 for m in MODS},
                                  modal_encoding=True), sd)
    y, attn = fuser(_inputs(ins), MODS, need_weights=True)
    _close(y, outs["y"], "fuser_temporal.y")
    _close(attn, outs["attn"], "fuser_temporal.attn")
    y2, none = fuser(_inputs(ins), MODS)  # 18 tokens: fused_seq_block
    assert none is None
    _close(y2, outs["y"], "fuser_temporal.y via fused_seq_block")


@torch.no_grad()
def test_fuser_temporal_frame_level_token_matches_jax():
    """No fixture has the frame-level tokens: the JAX fuser on the same
    weights is the reference (token slots first, fused = the first T)."""
    kwargs = dict(dim=64, depth=2, num_heads=4,
                  modalities={m: 64 for m in MODS}, modal_encoding=True,
                  frame_level_token=True, temporal_sequence_length=6)
    jfuser = JF.TemporalCMFuser(**kwargs)
    params = jfuser.init(jax.random.key(3))
    fuser = TemporalCMFuser(**kwargs)
    fuser.load_state_dict(W.fuser_from_jax(
        fuser, jax.tree.map(np.asarray, params)), strict=True)
    rng = np.random.default_rng(4)
    feats = {m: rng.standard_normal((2, 6, 64)).astype(np.float32)
             for m in MODS}
    want, want_attn = jfuser.apply(
        params, {m: jnp.asarray(v) for m, v in feats.items()}, MODS)
    y, attn = fuser(_inputs(feats), MODS, need_weights=True)
    _close(y, np.asarray(want), "frame-level token y")
    _close(attn, np.asarray(want_attn), "frame-level token attn")
    y2, _ = fuser(_inputs(feats), MODS)
    _close(y2, np.asarray(want), "frame-level token y via fused_seq_block")
    with pytest.raises(ValueError, match="frame-level tokens are 6"):
        fuser({m: v[:, :5] for m, v in _inputs(feats).items()}, MODS)


@torch.no_grad()
def test_fuser_ca():
    sd, ins, outs = load_fixture("fuser_ca")
    fuser = _load(TemporalCrossAttentFuser(
        dim=64, modalities={m: 64 for m in MODS}, num_heads=4), sd)
    assert len(fuser.blocks) == len(MODS) - 1
    y, dummy = fuser(_inputs(ins), MODS)
    _close(y, outs["y"], "fuser_ca.y")
    assert dummy.shape == (3,) and not dummy.any()
    # the module path of the decoder blocks gives the same
    x, *mems = [v + fuser.position_embeddings.weight[:6]
                for v in _inputs(ins).values()]
    mask = torch.triu(torch.full((6, 6), float("-inf")), 1)
    for blk, mem in zip(fuser.blocks, mems):
        x = blk(x, mem, mask)
    _close(fuser.norm(x), outs["y"], "fuser_ca.y via DecoderBlock")


def _predictor_pair(**kwargs):
    """(the port's predictor, the JAX predictor, its params) on the
    predictor fixture's weights."""
    sd, ins, outs = load_fixture("predictor")
    pred = _load(BaseFuturePredictor(in_features=64, inter_dim=64, n_layer=2,
                                     n_head=2, **kwargs), sd)
    jpred = JaxPredictor(in_features=64, inter_dim=64, n_layer=2, n_head=2,
                         **kwargs)
    return pred, jpred, TI.import_gpt2(sd, "", n_head=2), ins, outs


@torch.no_grad()
def test_predictor():
    pred, jpred, jparams, ins, outs = _predictor_pair()
    x = torch.from_numpy(ins["x"])
    y1, extra = pred(x, output_len=1)
    _close(y1, outs["y1"], "predictor.len1")
    assert extra == {}
    # the KV-cache rollout: against the reference, against the JAX
    # package's rollout, and against the port's own full re-run
    y3, extra = pred(x, output_len=3)
    assert extra == {}
    _close(y3, outs["y3"], "predictor.len3")
    want, _ = jpred._apply_kv_cache(jparams, jnp.asarray(ins["x"]), 3)
    _close(y3, np.asarray(want), "predictor.len3 vs _apply_kv_cache")
    rerun, _ = pred._apply_full(x, 3)
    _close(rerun, y3.numpy(), "rollout vs full re-run")
    plain, _ = pred(x, output_len=3, impl="plain")
    _close(plain, outs["y3"], "predictor.len3, impl=plain")


@pytest.mark.parametrize("output_len", [1, 3])
@torch.no_grad()
def test_predictor_output_attentions(output_len):
    pred, jpred, jparams, ins, _ = _predictor_pair(output_attentions=True)
    T = ins["x"].shape[1]
    want, want_extra = jpred.apply(jparams, jnp.asarray(ins["x"]),
                                   output_len)
    got, extra = pred(torch.from_numpy(ins["x"]), output_len=output_len)
    _close(got, np.asarray(want), "hidden")
    assert set(extra) == {f"gpt2_att_{i}" for i in range(output_len)}
    for i in range(output_len):
        key = f"gpt2_att_{i}"
        assert extra[key].shape == (3, 2, 2, T if i == 0 else 1, T + i)
        _close(extra[key], np.asarray(want_extra[key]), key)
    with pytest.raises(TypeError, match="must be a bool"):
        BaseFuturePredictor(in_features=64, output_attentions="false")


@torch.no_grad()
def test_cmfp_early():
    sd, ins, outs = load_fixture("cmfp_early")
    cmfp = _load(CMFPEarly(_cmfp_cfg(), NUM_CLASSES), sd)
    _check_outputs(cmfp(_inputs(ins)), outs)


@torch.no_grad()
def test_base_model():
    sd, ins, outs = load_fixture("base_model")
    cfg = _cmfp_cfg()
    cfg["common"]["backbones"] = {
        m: {"_target_": "torch.nn.Identity"} for m in MODS}
    cfg["CMFP"] = {"_target_": "models.future_prediction.CMFPEarly",
                   "model_cfg": None}
    model = _load(BaseModel(cfg, num_classes=NUM_CLASSES), sd)
    out = model(_inputs(ins))  # (B, T, F, 1, 1, 1) video-shaped inputs
    _check_outputs(out, outs)


@torch.no_grad()
def test_base_model_multicrop_averages_crops():
    """Two crops: the outputs are the mean of the two single-crop runs."""
    sd, ins, _ = load_fixture("base_model")
    cfg = _cmfp_cfg()
    cfg["CMFP"] = {"_target_": "models.future_prediction.CMFPEarly",
                   "model_cfg": None}
    model = _load(BaseModel(cfg, num_classes=NUM_CLASSES), sd)
    a = {m: torch.from_numpy(ins[m]) for m in MODS}
    b = {m: torch.flip(v, dims=[1]) for m, v in a.items()}
    both = model({m: torch.stack([a[m], b[m]], dim=2) for m in MODS})
    one, two = model(a), model(b)
    for key in ("logits/action", "past_logits/verb"):
        torch.testing.assert_close(
            both[key]["all-fused"],
            (one[key]["all-fused"] + two[key]["all-fused"]) / 2,
            rtol=RTOL, atol=ATOL)
