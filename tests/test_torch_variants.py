"""The variant models of the port against the JAX package, on the CPU:
expts 00 (``IndividualFuturePrediction``), 05 (``CMFPScoreFusion`` with
``MATT``), the training of expts 03 and 04 (T-SA- and CA-Fuser), and the
mappings beside the linear one.

- Every new module against its reference fixture (``sd::`` entries loaded
  with ``load_state_dict(strict=True)``) and against the JAX apply on the
  same weights carried by ``weights.py`` (fp32, atol 2e-5, rtol 1e-5, the
  tolerances of tests/test_parity.py); ``GatedEmbeddingUnit``, which has no
  fixture, against its JAX apply alone.
- The T-SA- and CA-Fuser in training mode, rates 0: the forward and the
  gradients of the parameters and the inputs against ``jax.grad`` of the
  JAX apply with ``train=True`` (gradients at atol 1e-5 of max|grad|).
- The four recorded trajectories ``train_trajectory_{individual, matt,
  temporal, ca}.npz`` (the reference's own loop, 30 steps) replayed through
  the port's ``Runner``: losses per step, the lr trace exactly (the
  individual leg's zero-lr tail included), the weights after steps 1-3
  (relative L2 < 1e-5) and 30 (< 2e-4).
- With the expts' rates on: finite losses and gradients, the seed decides
  the masks, eval mode ignores the rates.
- The training entry of row 4: its gradients equal plain autograd's, and
  it is chosen exactly where the JAX package chooses its Pallas kernel.
- The launcher on the synthetic smoke expt with the individual and the
  score-fusion models: one epoch, a checkpoint, then ``-m test`` on it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_trajectory as TT
from afft_tpu.config import compose as jax_compose
from afft_tpu.models import BaseModel as JaxBaseModel
from afft_tpu.models import cmfp as JC
from afft_tpu.models import fusion as JF
from afft_tpu.models import mapping as JM
from afft_tpu.ops import attention as JA
from afft_tpu.ops import pallas_attn as JPA
from afft_tpu.train import torch_import as TI
from afft_tpu_torch import run as RUN
from afft_tpu_torch import weights as W
from afft_tpu_torch.config import (CONF_DIR, compose, expt_lines_without,
                                   read_expt_file)
from afft_tpu_torch.models import BaseModel
from afft_tpu_torch.models import cmfp as C
from afft_tpu_torch.models import fusion as F
from afft_tpu_torch.models import layers as L
from afft_tpu_torch.models import mapping as M
from afft_tpu_torch.ops import attention as FA
from afft_tpu_torch.ops import launch_counts, reset_launches
from afft_tpu_torch.train import optim as O
from afft_tpu_torch.train.mixup import MixUp
from afft_tpu_torch.train.runner import Runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
JAX_CONF = os.path.join(REPO, "afft_tpu", "conf")
ATOL, RTOL = 2e-5, 1e-5
MODS = ["rgb", "objects", "flow"]
DIMS = {"rgb": 48, "objects": 20, "flow": 48}
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
    module.load_state_dict({k: torch.from_numpy(np.asarray(v))
                            for k, v in sd.items()}, strict=True)
    return module.eval()


def _close(got, want, name, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, f"{name}: {got.shape} vs {want.shape}"
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=name)


def _walk(out, key):
    for part in (p for p in key.split("//") if p):
        out = out[part]
    return out


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# -- mappings -----------------------------------------------------------------

MAPPINGS = [
    ("mapping_gated", M.GatedLinearMapping, JM.GatedLinearMapping,
     dict(use_layernorm=True)),
    ("mapping_nonlinear", M.NonLinearMapping, JM.NonLinearMapping,
     dict(use_layernorm=True, activation="relu")),
]


@pytest.mark.parametrize("name,cls,jcls,kwargs", MAPPINGS,
                         ids=[m[0] for m in MAPPINGS])
@torch.no_grad()
def test_mapping_against_fixture_and_jax(name, cls, jcls, kwargs):
    sd, ins, outs = load_fixture(name)
    mapping = _load(cls(32, 64, **kwargs), sd)
    x = torch.from_numpy(ins["x"])
    _close(mapping(x), outs["y"], name)
    jmap = jcls(32, 64, **kwargs)
    params = TI.import_mapping(jmap, sd, "")
    # the JAX parameters carried back give the fixture's state dict
    carried = W.mapping_from_jax(mapping, _np_tree(params))
    assert set(carried) == set(sd)
    for k, v in carried.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    _close(mapping(x), jmap.apply(params, jnp.asarray(ins["x"])),
           f"{name} vs JAX")


@pytest.mark.parametrize("cls,jcls,kwargs", [
    (M.GatedEmbeddingUnit, JM.GatedEmbeddingUnit, {}),
    (M.GatedLinearMapping, JM.GatedLinearMapping,
     dict(use_layernorm=False)),
    (M.NonLinearMapping, JM.NonLinearMapping,
     dict(use_layernorm=False, activation="gelu")),
    (M.NonLinearMapping, JM.NonLinearMapping,
     dict(use_layernorm=True, activation="none")),
], ids=["gated_embedding_unit", "gated_no_ln", "nonlinear_gelu",
        "nonlinear_none"])
@torch.no_grad()
def test_mapping_against_jax_apply(cls, jcls, kwargs):
    """Mappings without a fixture: the JAX apply on JAX-drawn weights."""
    jmap = jcls(24, 40, **kwargs)
    params = _np_tree(jmap.init(jax.random.key(3)))
    mapping = cls(24, 40, **kwargs)
    mapping.load_state_dict(W.mapping_from_jax(mapping, params),
                            strict=True)
    x = np.random.default_rng(0).standard_normal((3, 5, 24)).astype(
        np.float32)
    _close(mapping(torch.from_numpy(x)), jmap.apply(params, jnp.asarray(x)),
           cls.__name__)
    if cls is M.GatedEmbeddingUnit:
        assert set(mapping.state_dict()) == {"fc.weight", "fc.bias",
                                             "cg.fc.weight", "cg.fc.bias"}


# -- MATT and the two CMFPs -----------------------------------------------------

@torch.no_grad()
def test_matt_against_fixture_and_jax():
    sd, ins, outs = load_fixture("fuser_matt")
    fuser = _load(F.MATT({m: 64 for m in MODS}, dim=64), sd)
    feats = {m: torch.from_numpy(ins[m]) for m in MODS}
    w = fuser(feats, MODS)
    _close(w, outs["w"], "matt.w")
    torch.testing.assert_close(w.sum(-1), torch.ones(3, 6))
    jfuser = JF.MATT({m: 64 for m in MODS}, dim=64)
    params = TI.import_fuser(jfuser, sd, "")
    assert set(W.fuser_from_jax(fuser, _np_tree(params))) == set(sd)
    _close(w, jfuser.apply(params, {m: jnp.asarray(ins[m]) for m in MODS},
                           MODS), "matt vs JAX")
    # without dim the input is the sum of the modality widths
    assert F.MATT({"a": 8, "b": 24}).matt[0].in_features == 32


def _cmfp_cfg(fuser=None):
    """tests/test_parity.py's per-modality CMFP config."""
    cfg = {
        "modal_dims": dict(DIMS),
        "modal_feature_order": ["rgb", "objects", "audio", "poses", "flow"],
        "dropout": 0.2,
        "common": {
            "in_features": 48, "fp_inter_dim": 64, "fp_output_len": 1,
            "share_classifiers": False, "share_predictors": False,
            "modality_cls": True, "fusion_cls": False,
        },
        "mapping": {"_target_": "models.feature_mapping.Linear",
                    "use_layernorm": False, "sparse_mapping": True},
        "future_predictor": {
            "_target_": "models.future_prediction.BaseFuturePredictor",
            "in_features": 48, "inter_dim": 64, "n_layer": 2, "n_head": 2,
            "embd_pdrop": 0.1, "resid_pdrop": 0.1, "attn_pdrop": 0.1,
            "output_attentions": False},
    }
    if fuser is not None:
        cfg["fuser"] = fuser
    return cfg


MATT_CFG = {"_target_": "models.fusion.MATT", "modal_dims": dict(DIMS),
            "dim": 48}
CMFPS = [("cmfp_individual", C.IndividualFuturePrediction,
          JC.IndividualFuturePrediction, None),
         ("cmfp_scorefusion", C.CMFPScoreFusion, JC.CMFPScoreFusion,
          MATT_CFG)]


@pytest.mark.parametrize("name,cls,jcls,fuser", CMFPS,
                         ids=[c[0] for c in CMFPS])
@torch.no_grad()
def test_cmfp_against_fixture_and_jax(name, cls, jcls, fuser):
    sd, ins, outs = load_fixture(name)
    cmfp = _load(cls(_cmfp_cfg(fuser), NUM_CLASSES), sd)
    feats = {m: torch.from_numpy(ins[m]) for m in MODS}
    out = cmfp(feats)
    for key, want in outs.items():
        _close(_walk(out, key), want, key)
    assert not cmfp.common_predictor and not cmfp.common_classifier
    assert set(cmfp.predictors()) == set(MODS)
    # per-head classifiers take their modality's width
    assert cmfp.classifiers["action"]["objects"][1].in_features == 20
    jcmfp = jcls(_cmfp_cfg(fuser), NUM_CLASSES)
    params = TI.import_cmfp(jcmfp, sd, "")
    carried = W.cmfp_from_jax(cmfp, _np_tree(params))
    assert set(carried) == set(sd)
    for k, v in carried.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    want = jcmfp.apply(params, {m: jnp.asarray(ins[m]) for m in MODS})
    for key in outs:
        _close(_walk(out, key), _walk(want, key), f"{key} vs JAX")
    if fuser is not None:
        return  # score fusion weighs T + 1 frames: a single step only
    # the multi-step rollout of the per-modality predictors (KV cache)
    long_cfg = _cmfp_cfg(fuser)
    long_cfg["common"]["fp_output_len"] = 3
    rollout = _load(cls(long_cfg, NUM_CLASSES), sd)
    jlong = jcls(_cmfp_cfg(fuser) | {"common": long_cfg["common"]},
                 NUM_CLASSES)
    got = rollout(feats)
    want = jlong.apply(params, {m: jnp.asarray(ins[m]) for m in MODS})
    for key in ("future//rgb", "past_futures//objects"):
        _close(_walk(got, key), _walk(want, key), f"rollout {key}")


# -- JAX-initialised models load with no missing or unexpected keys ------------

VARIANT_OVERRIDES = {
    "individual": ["model/CMFP=individual", "model.common.fusion_cls=false",
                   "model.common.modality_cls=true",
                   "model.common.share_predictors=false",
                   "model.common.share_classifiers=false"],
    "scorefusion": ["model/CMFP=scorefusion", "model/fuser=MATT",
                    "model.common.fusion_cls=false",
                    "model.common.share_predictors=false",
                    "model.common.share_classifiers=false"],
    "scorefusion_gated": ["model/CMFP=scorefusion", "model/fuser=MATT",
                          "model/mapping=gatedlinear",
                          "model.common.fusion_cls=false"],
    "temporal_nonlinear": ["model/fuser=T-SA-Fuser",
                           "model/mapping=nonlinear"],
    "ca": ["model/fuser=CA-Fuser"],
}
SMOKE_TRAIN = os.path.join(REPO, "expts", "99_synth_smoke_train.txt")
SMOKE_VAL = os.path.join(REPO, "expts", "99_synth_smoke_val.txt")
SMOKE_CLASSES = {"action": 106, "verb": 19, "noun": 51}


def smoke_lines(variant, expt=SMOKE_TRAIN):
    """The smoke expt's lines with ``variant``'s overrides, without the
    lines that set keys the chosen fuser does not have (MATT takes none of
    the block fuser's, the CA-Fuser no depth)."""
    dropped = [key for choice, key in (
        ("model/fuser=MATT", "model.fuser."),
        ("model/fuser=CA-Fuser", "model.fuser.depth="))
        if choice in VARIANT_OVERRIDES[variant]]
    return expt_lines_without(expt, dropped) + VARIANT_OVERRIDES[variant]


@pytest.mark.parametrize("variant", sorted(VARIANT_OVERRIDES))
def test_jax_initialised_variant_loads_strictly(variant):
    """A JAX-initialised model of each variant (the smoke expt's widths)
    carries into the port with no missing or unexpected keys, its
    gradients too, and serves the JAX model's logits."""
    overrides = smoke_lines(variant)
    jmodel = JaxBaseModel(jax_compose(JAX_CONF, overrides).model,
                          num_classes=SMOKE_CLASSES)
    params = _np_tree(jmodel.init(jax.random.key(5)))
    model = BaseModel(compose(CONF_DIR, overrides).model,
                      num_classes=SMOKE_CLASSES)
    sd = W.state_dict_from_jax(model, params)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not missing and not unexpected
    grads = W.grads_from_jax(model, params)
    assert set(grads) == {n for n, _ in model.named_parameters()}
    x = np.random.default_rng(1).standard_normal((2, 10, 24)).astype(
        np.float32)
    with torch.no_grad():
        got = model.eval()({m: torch.from_numpy(x) for m in ("rgb", "flow")})
    want, _ = jmodel.apply(params, {m: jnp.asarray(x)
                                    for m in ("rgb", "flow")})
    for head, logits in want["logits/action"].items():
        _close(got["logits/action"][head], logits, f"{variant} {head}")


# -- the T-SA- and CA-Fuser in training mode ------------------------------------

def _fuser_pair(kind):
    mods = {m: 32 for m in MODS}
    if kind == "temporal":
        kw = dict(dim=32, depth=2, num_heads=4, modalities=mods,
                  modal_encoding=True)
        return F.TemporalCMFuser(**kw), JF.TemporalCMFuser(**kw)
    kw = dict(dim=32, num_heads=4, modalities=mods)
    return F.TemporalCrossAttentFuser(**kw), \
        JF.TemporalCrossAttentFuser(**kw)


@pytest.mark.parametrize("kind", ["temporal", "ca"])
def test_fuser_training_gradients_match_jax_grad(kind):
    fuser, jfuser = _fuser_pair(kind)
    params = jfuser.init(jax.random.key(7))
    fuser.load_state_dict(W.fuser_from_jax(fuser, _np_tree(params)),
                          strict=True)
    rng = np.random.default_rng(2)
    feats = {m: rng.standard_normal((3, 5, 32)).astype(np.float32)
             for m in MODS}
    w_out = rng.standard_normal((3, 5, 32)).astype(np.float32)

    def jloss(p, x):
        y, _ = jfuser.apply(p, x, MODS, train=True, rng=None,
                            need_weights=False)
        return jnp.sum(y * w_out), y

    (_, jy), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(
        params, {m: jnp.asarray(v) for m, v in feats.items()})
    x = {m: torch.from_numpy(v).requires_grad_() for m, v in feats.items()}
    fuser.train()
    y, _ = fuser(x, MODS)
    assert y.requires_grad
    (y * torch.from_numpy(w_out)).sum().backward()
    _close(y, jy, f"{kind} training forward")

    def close_grad(got, want, name):
        scale = float(np.abs(np.asarray(want)).max())
        _close(got, want, name, atol=1e-5 * scale)

    want = W.fuser_from_jax(fuser, _np_tree(jgp))
    named = dict(fuser.named_parameters())
    assert set(want) == set(named)
    for name, g in want.items():
        close_grad(named[name].grad, g.numpy(), name)
    for m in MODS:
        close_grad(x[m].grad, jgx[m], f"d{m}")


def test_fuser_training_rates_and_attention_route(monkeypatch):
    """With the expts' rates: the seed decides the masks, eval ignores
    them; the attention runs the row-4 entry exactly where no attention
    dropout is in force (once per block for the T-SA-Fuser, twice per
    decoder block for the CA-Fuser)."""
    calls = []
    apply = FA.FusedAttentionFn.apply
    monkeypatch.setattr(FA.FusedAttentionFn, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    mods = {m: 32 for m in MODS}
    x = {m: torch.randn(3, 5, 32, generator=torch.Generator().manual_seed(
        i)) for i, m in enumerate(MODS)}
    for cls, kw, per_pass in (
            (F.TemporalCMFuser, dict(depth=3), 3),
            (F.TemporalCrossAttentFuser, {}, 2 * (len(MODS) - 1))):
        rates = dict(embd_drop_rate=0.1, drop_rate=0.1, attn_drop_rate=0.1,
                     drop_path_rate=0.1)
        fuser = cls(dim=32, num_heads=4, modalities=mods, **kw, **rates)
        fuser.reset_parameters(torch.Generator().manual_seed(0))
        assert fuser.dpr == L.drop_path_schedule(0.1, len(fuser.blocks))
        assert [b.drop_path for b in fuser.blocks] == fuser.dpr
        calls.clear()
        a, _ = fuser(x, MODS, rng=L.RngStream(4))
        b, _ = fuser(x, MODS, rng=L.RngStream(4))
        c, _ = fuser(x, MODS, rng=L.RngStream(5))
        assert calls == [] and torch.equal(a, b) and not torch.equal(a, c)
        a.sum().backward()
        assert all(p.grad is not None and bool(p.grad.isfinite().all())
                   for p in fuser.parameters() if p.requires_grad)
        with pytest.raises(ValueError, match="RngStream"):
            fuser(x, MODS)
        with torch.no_grad():
            evaled = fuser.eval()(x, MODS)[0]
            bare = cls(dim=32, num_heads=4, modalities=mods, **kw)
            bare.load_state_dict(fuser.state_dict())
            torch.testing.assert_close(evaled, bare.eval()(x, MODS)[0],
                                       rtol=0, atol=0)
        # attention dropout 0: the row-4 entry at every attention site
        fuser.train()
        for blk in fuser.blocks:
            blk.attn_drop = 0.0
        fuser.attn_drop_rate = 0.0
        fuser(x, MODS, rng=L.RngStream(4))
        assert len(calls) == per_pass


# -- the training entry of row 4 ----------------------------------------------

@pytest.mark.parametrize("Nq,Nk,masked", [(5, 5, True), (7, 3, False),
                                          (1, 9, False)])
def test_fused_attention_fn_gradients_equal_plain_autograd(Nq, Nk, masked):
    gen = torch.Generator().manual_seed(Nq * 10 + Nk)
    q, k, v = (torch.randn(2, n, 3, 8, generator=gen).requires_grad_()
               for n in (Nq, Nk, Nk))
    mask = (torch.triu(torch.full((Nq, Nk), float("-inf")), 1) if masked
            else torch.zeros(Nq, Nk))
    g = torch.randn(2, Nq, 3, 8, generator=gen)
    out = FA.FusedAttentionFn.apply(q, k, v, mask)
    got = torch.autograd.grad(out, (q, k, v), g)
    ref = FA.attention_plain(q, k, v, mask)[0]
    want = torch.autograd.grad(ref, (q, k, v), g)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    for name, a, b in zip("qkv", got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6,
                                   msg=f"d{name}")
    # the bare kernel keeps refusing an operand that needs a gradient
    # (its check runs before any CUDA launch)
    from afft_tpu_torch.ops._common import check_no_grad
    with pytest.raises(RuntimeError, match="no backward"):
        check_no_grad("fused_attention", (q, k, v))


def test_training_entry_chosen_where_jax_chooses_pallas(monkeypatch):
    """JAX's ``multihead_attention`` dispatch, its platform gate open and
    its kernel's shape limits lifted (the port's kernel sets its own and
    raises beyond them), chooses ``_fused_attention_ad`` in exactly the
    cases where ``uses_kernel`` sends a site to ``FusedAttentionFn``."""
    chose = []
    monkeypatch.setattr(JA, "_use_pallas", lambda: True)
    monkeypatch.setattr(JPA, "supported", lambda *a, **k: True)
    monkeypatch.setattr(JA, "_fused_attention_ad",
                        lambda q, *a: chose.append(True) or q)
    monkeypatch.setattr(JA, "attention_reference",
                        lambda q, *a, **k: chose.append(False) or (q, None))
    q = np.zeros((2, 3, 2, 4), np.float32)
    kv = np.zeros((2, 5, 2, 4), np.float32)
    for weights in (False, True):
        for train in (False, True):
            for rate in (0.0, 0.1):
                JA.multihead_attention(q, kv, kv, attn_drop=rate,
                                       train=train, return_weights=weights)
                assert chose.pop() == FA.uses_kernel(
                    attn_drop=rate, train=train, return_weights=weights), \
                    (weights, train, rate)


# -- the recorded trajectories ---------------------------------------------------

def _variant_runner(d, variant):
    """The port's Runner as tests/test_trajectory.py builds the JAX one for
    ``variant``, from the fixture's initial state dict."""
    model = BaseModel(TT._model_cfg(variant), num_classes=TT.NUM_CLASSES,
                      class_mappings={})
    model.load_state_dict({k[5:]: torch.tensor(d[k]) for k in d.files
                           if k.startswith("sd0::")}, strict=True)
    named = list(model.named_parameters())
    lr_wd = None if variant in ("individual", "temporal", "ca") \
        else [["future_predictor.fuser", 0.01, 0.0]]
    groups = O.build_groups(named, lr_wd, TT.LR, TT.WD)
    assert {g.lr for g in groups.values()} == (
        {TT.LR} if lr_wd is None else {0.01, TT.LR})
    loss_wts = dict(TT.LOSS_WTS)
    if variant == "matt":
        loss_wts["past_cls_action"] = 0.0
    mixup = MixUp(alpha=0.1, label_smoothing={"action": 0.4, "verb": 0.01,
                                              "noun": 0.03},
                  num_classes=TT.NUM_CLASSES)
    return Runner(model, O.sgd(momentum=0.9, nesterov=True), groups,
                  loss_wts=loss_wts, mixup=mixup, mixup_backbone=True,
                  grad_clip=1.0)


@pytest.mark.parametrize("variant", ["individual", "matt", "temporal",
                                     "ca"])
def test_recorded_variant_trajectory_replays(variant):
    """30 steps of the reference loop: losses (first step rtol 1e-4 / atol
    1e-5, total 1e-5; the trajectory 2e-3 on the total and 5e-3 on the
    components), the lr trace (rtol 1e-6, and exactly zero where the
    reference's is), the weights after steps 1-3 (relative L2 < 1e-5) and
    after step 30 (< 2e-4): tests/test_trajectory.py's tolerances."""
    d = np.load(TT._fixture_path(variant))
    assert list(d["meta"]) == [TT.B, TT.T, TT.EPOCHS, TT.ITERS,
                               TT.VAL_ITERS]
    runner = _variant_runner(d, variant)
    cos_epochs = 2 if variant == "individual" else TT.EPOCHS
    schedule = O.warmup_wrap(
        O.cosine_schedule(cos_epochs, TT.ITERS, world_size=1, eta_min=1e-6),
        init_lr_ratio=0.01, num_epochs=1, iters_per_epoch=TT.ITERS)
    mods = ["rgb"] if variant == "individual" else TT.MODS
    batches = TT._batches(d, "batch", TT.EPOCHS * TT.ITERS, lam=d["lam"],
                          mods=mods)

    def rel_l2(prefix):
        worst = 0.0
        sd = runner.model.state_dict()
        keys = [k for k in d.files if k.startswith(prefix)]
        assert len(keys) == len(sd)
        for k in keys:
            want = d[k]
            diff = np.linalg.norm(sd[k[len(prefix):]].numpy() - want)
            worst = max(worst, diff / max(np.linalg.norm(want), 1e-8))
        return worst

    reset_launches()
    got, lrs = [], []
    for i, batch in enumerate(batches):
        lr = schedule(i, TT.LR)
        losses, _ = runner.train_step(batch, lr, TT.LR, check_nan=True)
        got.append({k: float(v) for k, v in losses.items()})
        lrs.append(lr)
        if i < 3:
            assert rel_l2(f"step{i}::") < 1e-5, f"weights after step {i + 1}"
    assert sum(launch_counts().values()) == 0      # CPU: plain versions
    np.testing.assert_allclose(lrs, d["lr::rest"], rtol=1e-6, atol=1e-9)
    zero = d["lr::rest"] == 0.0
    assert (np.asarray(lrs)[zero] == 0.0).all()
    if variant == "individual":
        assert zero.any(), "the individual leg's zero-lr tail is missing"
    keys = [k[6:] for k in d.files if k.startswith("iter::")
            and "total_loss" not in k and "acc" not in k]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[0][k], d[f"iter::{k}"][0], rtol=1e-4,
                                   atol=1e-5, err_msg=f"iter 0 loss {k}")
        np.testing.assert_allclose([r[k] for r in got], d[f"iter::{k}"],
                                   rtol=5e-3, atol=5e-3, err_msg=k)
    np.testing.assert_allclose(got[0]["total_loss"],
                               d["iter::total_loss"][0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose([r["total_loss"] for r in got],
                               d["iter::total_loss"], rtol=2e-3, atol=2e-3)
    assert rel_l2("sdF::") < 2e-4


# -- the expts with their rates on ------------------------------------------------

EXPTS = {
    "00_individual": ("00_RGB_TSN_ek100_train.txt",
                      ["model.modal_dims={rgb:32}", "model.common_dim=32"]),
    "03_t_sa": ("03_T-SA-Fuser_ek100_train.txt", ["model.fuser.depth=2"]),
    "04_ca": ("04_CA-Fuser_ek100_train.txt", []),
    "05_matt": ("05_MATT_ek100_train.txt", []),
}
NARROW = ["model.modal_dims={rgb:32, objects:20, audio:32, flow:32}",
          "model.common_dim=32", "model.common.fp_inter_dim=64",
          "model.common.fp_layers=2"]
EXPT_CLASSES = {"action": 23, "verb": 7, "noun": 9}


def _expt_cfg(key, more=()):
    expt, narrow = EXPTS[key]
    return compose(CONF_DIR, read_expt_file(os.path.join(REPO, "expts", expt))
                   + NARROW + narrow + list(more))


def _expt_batch(cfg, batch=4, seed=0):
    rng = np.random.default_rng(seed)
    T = int(cfg.data_train.num_frames)
    return {
        "data_dict": {m: rng.standard_normal((batch, T, int(d))).astype(
            np.float32) for m, d in cfg.model.modal_dims.to_container()
            .items()},
        "target": {t: rng.integers(0, c, (batch,))
                   for t, c in EXPT_CLASSES.items()},
        "target_subclips": {t: rng.integers(0, c, (batch, T, 1))
                            for t, c in EXPT_CLASSES.items()}}


@pytest.mark.parametrize("key", sorted(EXPTS))
def test_expts_train_with_their_rates(key):
    cfg = _expt_cfg(key)
    batch = _expt_batch(cfg)

    def steps(seed, n=2):
        runner = Runner.from_config(cfg, EXPT_CLASSES, device="cpu")
        runner.rng = L.RngStream(seed)
        out = []
        for _ in range(n):
            losses, _ = runner.train_step(batch, runner.base_lr,
                                          runner.base_lr, check_nan=True)
            out.append(float(losses["total_loss"]))
            grads = [p.grad for p in runner.model.parameters()
                     if p.grad is not None]
            assert grads and all(bool(g.isfinite().all()) for g in grads)
        return out, runner

    a, runner = steps(0)
    b, _ = steps(0)
    c, _ = steps(1)
    assert all(np.isfinite(a)) and a == b and a != c
    # eval mode ignores the rates: the same weights with every rate 0
    rates0 = ["model.dropout=0.0", "model.common.embd_pdrop=0.0",
              "model.common.resid_pdrop=0.0", "model.common.attn_pdrop=0.0"
              ] + [f"model.fuser.{r}=0.0" for r in (
                  "drop_rate", "embd_drop_rate", "attn_drop_rate",
                  "drop_path_rate") if r in cfg.model.fuser]
    bare = BaseModel(_expt_cfg(key, rates0).model, num_classes=EXPT_CLASSES)
    bare.load_state_dict(runner.model.state_dict())
    feats = {m: torch.from_numpy(v) for m, v in batch["data_dict"].items()}
    with torch.no_grad():
        got = runner.model.eval()(feats)
        want = bare.eval()(feats)
    for head, logits in want["logits/action"].items():
        torch.testing.assert_close(got["logits/action"][head], logits,
                                   rtol=0, atol=0)


# -- the launcher -------------------------------------------------------------

@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """A working directory whose ``tests`` is the repo's (the expts find
    their data under ``${cwd}``)."""
    (tmp_path / "tests").symlink_to(os.path.join(REPO, "tests"))
    monkeypatch.chdir(tmp_path)
    import signal
    handler = signal.getsignal(signal.SIGTERM)
    yield tmp_path
    signal.signal(signal.SIGTERM, handler)


LAUNCH = {
    "individual": (["primary_metric=val_mt5r_action_rgb"],
                   "IndividualFuturePrediction_ModalTokenCMFuser_rgb_flow"),
    "scorefusion": ([], "CMFPScoreFusion_MATT_rgb_flow"),
}


@pytest.mark.parametrize("variant", sorted(LAUNCH))
def test_launcher_trains_and_tests_the_variant(workdir, variant):
    """The smoke expt with the variant's overrides (an expt file of its
    own where MATT drops the block fuser's lines)."""
    extra, model_dir = LAUNCH[variant]
    for mode, base in (("train", SMOKE_TRAIN), ("val", SMOKE_VAL)):
        (workdir / f"variant_{mode}.txt").write_text(
            "\n".join(smoke_lines(variant, base)) + "\n")
    common = ["--device", "cpu", "workers=2", "use_wandb=false", *extra]
    best = RUN.main(["-c", str(workdir / "variant_train.txt"), "-m", "train",
                     "train.num_epochs=1", *common])
    assert best is not None and np.isfinite(best)
    ckpt = workdir / "checkpoints" / f"{model_dir}_synth-smoke"
    assert {"checkpoint_best", "checkpoint_last", "metrics.jsonl"} <= set(
        os.listdir(ckpt))
    accs = RUN.main(["-c", str(workdir / "variant_val.txt"), "-m", "test",
                     "save_name=null", f"init_from_model={model_dir}"
                     "_synth-smoke/checkpoint_best", *common])
    assert {"vtop1", "atop5", "amt5r"} <= set(accs)
    assert all(np.isfinite(v) for k, v in accs.items() if "top" in k)
