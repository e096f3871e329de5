"""The port's serving slice end to end against the JAX package, on the CPU.

The same expt-style config is composed over each package's conf tree; the
JAX BaseModel's seeded parameters are carried into the port by
``weights.state_dict_from_jax``; the same numpy-seeded features go through
both. fp32 throughout. Tolerance: tests/test_parity.py's atol 2e-5 / rtol
1e-5, here over two fuser blocks and two GPT-2 layers (only the summation
order differs).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from afft_tpu.config import compose as jax_compose
from afft_tpu.models import BaseModel as JaxBaseModel
from afft_tpu.train import torch_export as TE
from afft_tpu_torch import serve, weights as W
from afft_tpu_torch.config import CONF_DIR, compose, read_expt_file
from afft_tpu_torch.models import BaseModel
from afft_tpu_torch.ops import launch_counts, reset_launches

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 2e-5
RTOL = 1e-5

# the flagship expt at depth 2 and narrow widths (4 modalities, ragged
# objects width, T=16), and the synthetic smoke expt
CONFIGS = {
    "flagship_narrow": ("expts/01_SA-Fuser_ek100_val_Swin.txt", [
        "model.modal_dims={rgb:32, objects:20, audio:32, flow:32}",
        "model.common_dim=32", "model.fuser.depth=2",
        "model.common.fp_inter_dim=64", "model.common.fp_layers=2"]),
    "synth_smoke": ("expts/99_synth_smoke_val.txt", []),
}
NUM_CLASSES = {"action": 23}


def _configs(name, more=()):
    expt, extra = CONFIGS[name]
    overrides = read_expt_file(os.path.join(REPO, expt)) + extra + list(more)
    return (jax_compose(os.path.join(REPO, "afft_tpu/conf"), overrides),
            compose(CONF_DIR, overrides))


def _features(cfg, batch, seed=0):
    rng = np.random.default_rng(seed)
    T = int(cfg.data_eval.num_frames)
    return {m: rng.standard_normal((batch, T, int(d))).astype(np.float32)
            for m, d in cfg.model.modal_dims.to_container().items()}


def _jax_model(cfg, num_classes=NUM_CLASSES):
    model = JaxBaseModel(cfg.model, num_classes=num_classes)
    params = model.init(jax.random.key(7))
    return model, params, jax.tree.map(np.asarray, params)


def _flatten(out, prefix=""):
    flat = {}
    for k, v in out.items():
        if isinstance(v, dict):
            flat.update(_flatten(v, f"{prefix}{k}//"))
        elif v is not None:
            flat[prefix + k] = np.asarray(v)
    return flat


@torch.no_grad()
def test_base_model_matches_jax():
    jcfg, tcfg = _configs("flagship_narrow")
    jmodel, jparams, params_np = _jax_model(jcfg)
    model = BaseModel(tcfg.model, num_classes=NUM_CLASSES).eval()
    model.load_state_dict(W.state_dict_from_jax(model, params_np),
                          strict=True)
    feats = _features(tcfg, batch=3)
    want = jax.jit(lambda p, f: jmodel.apply(p, f)[0])(
        jparams, {m: jnp.asarray(v) for m, v in feats.items()})
    reset_launches()
    got = model({m: torch.from_numpy(v) for m, v in feats.items()})
    assert sum(launch_counts().values()) == 0  # CPU: plain versions only
    want, got = _flatten(want), _flatten(
        {k: v for k, v in got.items() if k != "attentions"})
    want.pop("attentions//all-fused//modality_attns", None)
    assert set(got) == set(want)
    assert any(k.startswith("logits/") for k in got)
    assert any(k.startswith("past_logits/") for k in got)
    for key in sorted(want):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                   atol=ATOL, err_msg=key)


@torch.no_grad()
def test_server_matches_jax_serving_fn():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from export_serving import build_serving_fn

    jcfg, tcfg = _configs("synth_smoke")
    jmodel, jparams, fwd = build_serving_fn(jcfg, NUM_CLASSES, "float32",
                                            topk=5)
    params_np = jax.tree.map(np.asarray, jparams)
    server = serve.Server(tcfg, NUM_CLASSES, "float32", device="cpu")
    server.model.load_state_dict(
        W.state_dict_from_jax(server.model, params_np), strict=True)
    feats = _features(tcfg, batch=5, seed=3)
    want_v, want_i = jax.jit(fwd)(
        jparams, {m: jnp.asarray(v) for m, v in feats.items()})
    # two requests of 2 and 3 clips, answered by one forward
    requests = [{m: torch.from_numpy(v[:2]) for m, v in feats.items()},
                {m: torch.from_numpy(v[2:]) for m, v in feats.items()}]
    answers = server.answer(requests)
    assert [a[0].shape for a in answers] == [(2, 5), (3, 5)]
    values = torch.cat([a[0] for a in answers]).numpy()
    indices = torch.cat([a[1] for a in answers]).numpy()
    np.testing.assert_array_equal(indices, np.asarray(want_i))
    np.testing.assert_allclose(values, np.asarray(want_v), rtol=RTOL,
                               atol=ATOL)


def test_state_dict_from_jax_equals_torch_export():
    """Key for key and value for value equal to the JAX package's own
    reference-layout export, on a model with a LayerNorm'd mapping, modal
    encoding and a multi-head GPT-2 (the c_attn re-interleave)."""
    jcfg, tcfg = _configs("flagship_narrow", [
        "model.mapping.use_layernorm=true",
        "model.mapping.sparse_mapping=false",
        "model.fuser.modal_encoding=true"])
    jmodel, _, params_np = _jax_model(jcfg, {"action": 11, "verb": 5})
    model = BaseModel(tcfg.model, num_classes={"action": 11, "verb": 5})
    got = W.state_dict_from_jax(model, params_np)
    want = TE.export_base_model(jmodel, params_np)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # the port's modules carry exactly the reference names
    assert set(model.state_dict()) == set(want)


def test_load_reference_checkpoint(tmp_path):
    sd = {"a.weight": torch.arange(6.0).reshape(2, 3), "b": torch.ones(2)}
    for wrap in ("model", "model_state", None):
        path = tmp_path / f"{wrap}.pth"
        torch.save({wrap: sd} if wrap else sd, path)
        got = W.load_reference_checkpoint(str(path))
        assert set(got) == set(sd)
        for k in sd:
            torch.testing.assert_close(got[k], sd[k])
