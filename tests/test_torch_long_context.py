"""Every sequence length the JAX package answers, on the CPU: the port at
GPT-2 contexts past 32 tokens, fuser rows past 8 tokens and sequence
attention past 1,024 keys against the JAX package's XLA route.

On a CUDA tensor those lengths take the long attention route
(``csrc/long_attention.cuh``, chosen by ``ops._common.check_length``); on
the CPU every wrapper runs its plain version, which takes any length, so
these tests hold the port's model and training paths at those lengths
against the JAX package, which computes them in XLA where its Pallas
kernels' ``supported()`` says no. The same numpy-seeded weights go through
both (carried by ``weights.state_dict_from_jax``), the same numpy-seeded
features; fp32, narrow widths (C 32, GPT-2 64 wide, 2 heads, 2 layers).
Tolerance: atol 2e-5 / rtol 1e-5 (tests/test_parity.py's; only the
summation order differs). Gradients are held at rtol 1e-5 plus an atol of
2e-5 of each tensor's largest magnitude: a gradient is a sum over the
batch's rows whose terms cancel where it is small, so the two frameworks'
orders differ by a share of the gradient's own scale.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afft_tpu.config import compose as jax_compose
from afft_tpu.models import BaseModel as JaxBaseModel
from afft_tpu.ops import attention as JA
from afft_tpu_torch import weights as W
from afft_tpu_torch.config import CONF_DIR, compose, read_expt_file
from afft_tpu_torch.models import BaseModel
from afft_tpu_torch.ops import (_common, launch_counts, long_launch_counts,
                                reset_launches)
from afft_tpu_torch.ops import attention as FA
from afft_tpu_torch.ops import fused_block as FB
from afft_tpu_torch.ops import fused_gpt2 as FG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 2e-5
RTOL = 1e-5
VAL = "expts/01_SA-Fuser_ek100_val_Swin.txt"
TRAIN = "expts/01_SA-Fuser_ek100_train.txt"
NARROW = ["model.modal_dims={rgb:32, objects:20, audio:32, flow:32}",
          "model.common_dim=32", "model.fuser.depth=2",
          "model.fuser.num_heads=2", "model.common.fp_inter_dim=64",
          "model.common.fp_layers=2", "model.common.fp_heads=2"]
NO_DROPOUT = ["model.dropout=0.0", "model.fuser.embd_drop_rate=0.0",
              "model.fuser.drop_rate=0.0", "model.fuser.attn_drop_rate=0.0",
              "model.fuser.drop_path_rate=0.0", "model.common.embd_pdrop=0.0",
              "model.common.resid_pdrop=0.0", "model.common.attn_pdrop=0.0"]
# nine modalities: the SA-Fuser's rows are 10 tokens with its modal token
NINE = ["model.modal_dims={rgb:32, objects:20, audio:32, flow:32, m4:16, "
        "m5:24, m6:8, m7:32, m8:16}"]
NUM_CLASSES = {"action": 23}


def _configs(expt, more=()):
    overrides = read_expt_file(os.path.join(REPO, expt)) + list(more)
    return (jax_compose(os.path.join(REPO, "afft_tpu/conf"), overrides),
            compose(CONF_DIR, overrides))


def _models(jcfg, tcfg, seed=7, jit_init=False):
    """The JAX model, its parameters (drawn by ``init``, jitted with
    ``jit_init``: one compile in place of an op-by-op draw) and the port's
    model on the same weights."""
    jmodel = JaxBaseModel(jcfg.model, num_classes=NUM_CLASSES)
    init = jax.jit(jmodel.init) if jit_init else jmodel.init
    jparams = init(jax.random.key(seed))
    model = BaseModel(tcfg.model, num_classes=NUM_CLASSES)
    model.load_state_dict(W.state_dict_from_jax(
        model, jax.tree.map(np.asarray, jparams)), strict=True)
    return jmodel, jparams, model


def _features(cfg, batch, seed, split="data_eval"):
    rng = np.random.default_rng(seed)
    T = int(cfg[split].num_frames)
    return {m: rng.standard_normal((batch, T, int(d))).astype(np.float32)
            for m, d in cfg.model.modal_dims.to_container().items()}


def _flatten(out, prefix=""):
    flat = {}
    for k, v in out.items():
        if isinstance(v, dict):
            flat.update(_flatten(v, f"{prefix}{k}//"))
        elif v is not None:
            flat[prefix + k] = np.asarray(v)
    return flat


@torch.no_grad()
def _outputs_match(jmodel, jparams, model, feats):
    """Every output of the port's eval forward against JAX
    ``BaseModel.apply``; returns the port's flattened outputs."""
    want = jax.jit(lambda p, f: jmodel.apply(p, f)[0])(
        jparams, {m: jnp.asarray(v) for m, v in feats.items()})
    reset_launches()
    got = model.eval()({m: torch.from_numpy(v) for m, v in feats.items()})
    assert sum(launch_counts().values()) == 0  # CPU: plain versions only
    want = {k: v for k, v in _flatten(want).items()
            if not k.startswith("attentions//")}
    got = _flatten({k: v for k, v in got.items() if k != "attentions"})
    assert set(got) == set(want)
    for key in sorted(want):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                   atol=ATOL, err_msg=key)
    return got


def _scalar(out):
    return sum((out[k]["all-fused"] ** 2).sum() for k in out
               if "logits/" in k or k == "past_futures")


def _gradients_match(jmodel, jparams, model, feats):
    """One backward of the same scalar of the training forward (every rate
    0) in both packages: every parameter's gradient."""
    want = jax.jit(jax.grad(lambda p, f: _scalar(jmodel.apply(
        p, f, train=True, rng=None)[0])))(
            jparams, {m: jnp.asarray(v) for m, v in feats.items()})
    model.train()
    model.zero_grad()
    _scalar(model({m: torch.from_numpy(v) for m, v in feats.items()})
            ).backward()
    want = W.grads_from_jax(model, jax.tree.map(np.asarray, want))
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        # a parameter the pass does not reach gets None: its JAX gradient
        # must be 0
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, ref, rtol=RTOL,
                                   atol=ATOL * max(np.abs(ref).max(), 1.0),
                                   err_msg=name)


@pytest.mark.parametrize("T", [33, 48, 96])
def test_predictor_past_32_tokens_matches_jax(T):
    """The flagship served at a GPT-2 context of T frames (past the staged
    attention's 32): every output, the past logits over all T frames."""
    jcfg, tcfg = _configs(VAL, NARROW + [f"data_eval.num_frames={T}"])
    got = _outputs_match(*_models(jcfg, tcfg), _features(tcfg, 2, seed=T))
    assert got["logits/action//all-fused"].shape == (2, 1, 23)
    assert got["past_logits/action//all-fused"].shape == (2, T, 23)


def test_gpt2_head_width_1024_matches_jax():
    """Past 32 tokens at a head width over 768 (the long route's streamed
    form on the card): a 1-layer GPT-2 at n_embd 1,024 with one head (hd
    1,024), T 40: every output of the eval forward, then every parameter's
    gradient of the training pass (dropout 0)."""
    jcfg, tcfg = _configs(VAL, NARROW + NO_DROPOUT + [
        "model.common.fp_inter_dim=1024", "model.common.fp_layers=1",
        "model.common.fp_heads=1", "data_eval.num_frames=40"])
    jmodel, jparams, model = _models(jcfg, tcfg, seed=10, jit_init=True)
    predictor = model.future_predictor.predictors()["shared"]
    assert predictor.n_head == 1 and predictor.gpt_model.wpe.weight.shape[1] \
        == 1024 and len(predictor.gpt_model.h) == 1
    feats = _features(tcfg, 2, seed=1024)
    got = _outputs_match(jmodel, jparams, model, feats)
    assert got["past_logits/action//all-fused"].shape == (2, 40, 23)
    _gradients_match(jmodel, jparams, model, feats)


def test_train_step_at_40_frames_matches_jax():
    """A training pass at T 40 (dropout 0): every parameter's gradient,
    then one ``Runner.train_step`` of each package from the same weights and
    batch: every loss component and the total."""
    import test_torch_train_slice as TS
    from afft_tpu.config import instantiate as jax_instantiate
    from afft_tpu.train import optim as JO
    from afft_tpu.train.mixup import MixUp as JaxMixUp
    from afft_tpu.train.runner import Runner as JaxRunner
    from afft_tpu_torch.train.runner import Runner

    more = TS.NARROW + NO_DROPOUT + ["data_train.num_frames=40"]
    jcfg = jax_compose(os.path.join(REPO, "afft_tpu/conf"),
                       TS._overrides(more))
    tcfg = compose(CONF_DIR, TS._overrides(more))
    jmodel = JaxBaseModel(jcfg.model, num_classes=TS.NUM_CLASSES)
    params = jmodel.init(jax.random.key(11))
    params0 = jax.tree.map(np.asarray, params)
    batch = TS._batches(tcfg, 1, seed=4)[0]
    assert batch["data_dict"]["rgb"].shape[1] == 40
    model = BaseModel(tcfg.model, num_classes=TS.NUM_CLASSES)
    model.load_state_dict(W.state_dict_from_jax(model, params0), strict=True)
    _gradients_match(jmodel, params, model, batch["data_dict"])

    groups = JO.build_group_tree(params, jcfg.opt.lr_wd, jcfg.opt.lr,
                                 jcfg.opt.wd)
    joptimizer = jax_instantiate(jcfg.opt.optimizer)
    jrunner = JaxRunner(
        jmodel, joptimizer, groups,
        loss_wts=dict(jcfg.train.loss_wts.items()),
        mixup=JaxMixUp(alpha=jcfg.train.mixup_alpha,
                       label_smoothing=dict(
                           jcfg.train.label_smoothing.items()),
                       num_classes=TS.NUM_CLASSES),
        mixup_backbone=jcfg.train.mixup_backbone,
        grad_clip=jcfg.opt.grad_clip, donate=False)
    jbatch = {**batch, "mixup_lam": jnp.asarray(batch["mixup_lam"])}
    _, _, want, _, _ = jrunner.train_step(
        params, joptimizer.init(params, groups), jbatch, 0.01, jcfg.opt.lr,
        jax.random.key(0))
    runner = Runner.from_config(tcfg, TS.NUM_CLASSES, device="cpu",
                                iters_per_epoch=TS.ITERS)
    runner.model.load_state_dict(W.state_dict_from_jax(runner.model,
                                                       params0), strict=True)
    got, _ = runner.train_step(batch, 0.01, runner.base_lr, check_nan=True)
    assert set(got) == set(want) and len(got) == 8
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=RTOL,
                                   atol=1e-6, err_msg=k)


def test_rollout_training_35_tokens_matches_jax():
    """``fp_output_len=20`` at T 16 in training mode: every step re-runs the
    whole sequence, the last through 35 tokens of the GPT-2 training
    layers; every output against JAX (the training layers' gradients past
    32 tokens: ``test_train_step_at_40_frames_matches_jax``)."""
    jcfg, tcfg = _configs(TRAIN, NARROW + NO_DROPOUT + [
        "model.common.fp_output_len=20"])
    jmodel, jparams, model = _models(jcfg, tcfg, seed=3)
    feats = _features(tcfg, 2, seed=9, split="data_train")
    assert next(iter(feats.values())).shape[1] == 16
    want = _flatten(jax.jit(lambda p, f: jmodel.apply(
        p, f, train=True, rng=None)[0])(
            jparams, {m: jnp.asarray(v) for m, v in feats.items()}))
    model.train()
    with torch.no_grad():
        got = _flatten(model({m: torch.from_numpy(v)
                              for m, v in feats.items()}))
    assert got["logits/action//all-fused"].shape == (2, 20, 23)
    for key in sorted(k for k in want if not k.startswith("attentions//")):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                   atol=ATOL, err_msg=key)


def test_sa_fuser_over_nine_modalities_matches_jax():
    """The SA-Fuser over nine modalities: rows of 10 tokens (past the rows
    kernel's 8) served and trained, against JAX."""
    jcfg, tcfg = _configs(TRAIN, NARROW + NINE + NO_DROPOUT)
    jmodel, jparams, model = _models(jcfg, tcfg, seed=5)
    fuser = model.future_predictor.fuser
    feats = _features(tcfg, 2, seed=2)
    assert len(feats) == 9 and fuser.modal_token is not None
    _outputs_match(jmodel, jparams, model, feats)
    _gradients_match(jmodel, jparams, model,
                     _features(tcfg, 2, seed=4, split="data_train"))


@torch.no_grad()
def test_t_sa_fuser_past_1024_tokens_matches_jax():
    """The T-SA-Fuser over 4 modalities x 260 frames = 1,040 tokens (its
    position table raised to 260 frames), past the sequence attention's
    1,024 keys: every output against JAX."""
    frames = 260
    jcfg, tcfg = _configs("expts/03_T-SA-Fuser_ek100_train.txt", NARROW + [
        f"+model.fuser.max_position_embeddings={frames}",
        f"data_eval.num_frames={frames}"])
    jmodel, jparams, model = _models(jcfg, tcfg, seed=6)
    assert model.future_predictor.fuser.position_embeddings.weight.shape[0] \
        == frames
    got = _outputs_match(jmodel, jparams, model,
                         _features(tcfg, 1, seed=frames))
    assert got["past_logits/action//all-fused"].shape == (1, frames, 23)


@pytest.mark.parametrize("mask", ["none", "causal"])
def test_attention_past_1024_keys_matches_jax(mask):
    """``attention_plain`` (and ``fused_attention``, which takes it on the
    CPU) over 1,100 keys against the JAX package's attention reference."""
    rng = np.random.default_rng(1100)
    B, Nq, Nk, H, hd = 2, 7, 1100, 2, 16
    q, k, v = (rng.standard_normal((B, n, H, hd)).astype(np.float32)
               for n in (Nq, Nk, Nk))
    m = None
    if mask == "causal":
        m = np.where(np.arange(Nk)[None, :] > np.arange(Nq)[:, None] + 1000,
                     -np.inf, 0.0).astype(np.float32)
    want = np.asarray(JA.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if m is None else jnp.asarray(m))[0])
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    tm = None if m is None else torch.from_numpy(m)
    got = FA.attention_plain(tq, tk, tv, tm)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.array_equal(FA.fused_attention(tq, tk, tv, tm).numpy(), got)


@torch.no_grad()
def test_synth_smoke_slice_at_40_frames_matches_jax():
    """The whole slice: expt 99's model at 40 frames (its GPT-2 past 32
    tokens), logits and every other output against JAX."""
    jcfg, tcfg = _configs("expts/99_synth_smoke_train.txt", [
        "data_train.num_frames=40", "data_eval.num_frames=40"])
    got = _outputs_match(*_models(jcfg, tcfg, seed=8),
                         _features(tcfg, 3, seed=40))
    assert got["logits/action//all-fused"].shape == (3, 1, 23)


@pytest.mark.parametrize("kind, short", [("fuser", 8), ("gpt2", 32),
                                         ("keys", 1024)])
def test_length_rule(kind, short):
    """``check_length``: any length from 1; past the short kernel's the long
    route, which takes any head width (past 768 columns its kernels stream
    their operand rows) and a bounded query count; no length is refused
    below that count."""
    rule = _common.check_length
    assert rule("t", kind, 1, 64) is False
    assert rule("t", kind, short, 4096) is False       # short: any hd
    for hd in (768, 769, 1024, 4096):                  # long: any hd
        assert rule("t", kind, short + 1, hd) is True
    assert rule("t", kind, 100_000, 64) is True
    for n, hd, queries in ((0, 64, None),
                           (short + 1, 64, _common.LONG_MAX_QUERIES + 1)):
        with pytest.raises(ValueError):
            rule("t", kind, n, hd, n_queries=queries)


def test_predictor_refuses_past_n_positions():
    """A context (with its rollout) past GPT-2's 1,024 positions raises a
    ValueError up front, on any device, as the position table ends."""
    _, tcfg = _configs(VAL, NARROW + ["model.common.fp_output_len=2"])
    model = BaseModel(tcfg.model, num_classes=NUM_CLASSES).eval()
    predictor = model.future_predictor.predictors()["shared"]
    with pytest.raises(ValueError, match="n_positions"):
        predictor(torch.zeros(1, 1024, 64), output_len=2)
    with torch.no_grad():
        out, _ = predictor(torch.zeros(1, 1023, 64), output_len=2)
    assert out.shape == (1, 1024, 64)


def test_wrappers_take_long_rows_on_the_cpu():
    """The serving wrappers at N 10 / T 40 on CPU tensors: their plain
    versions, no launch counted on either route."""
    g = torch.Generator().manual_seed(0)
    C, hidden = 32, 64
    pb = {"attn.qkv.weight": torch.randn(3 * C, C, generator=g) * 0.1,
          "attn.proj.weight": torch.randn(C, C, generator=g) * 0.1,
          "mlp.mlp.0.weight": torch.randn(hidden, C, generator=g) * 0.1,
          "mlp.mlp.2.weight": torch.randn(C, hidden, generator=g) * 0.1}
    x = torch.randn(3, 10, C, generator=g)
    reset_launches()
    torch.testing.assert_close(
        FB.fused_block(x, pb, None, num_heads=2),
        FB.fused_block_plain(x, pb, None, num_heads=2), rtol=0, atol=0)
    pg = {"attn.c_attn.weight": torch.randn(C, 3 * C, generator=g) * 0.1,
          "attn.c_proj.weight": torch.randn(C, C, generator=g) * 0.1,
          "mlp.c_fc.weight": torch.randn(C, hidden, generator=g) * 0.1,
          "mlp.c_proj.weight": torch.randn(hidden, C, generator=g) * 0.1}
    y = torch.randn(2, 40, C, generator=g)
    mask = torch.full((40, 40), float("-inf")).triu(1)
    torch.testing.assert_close(
        FG.fused_gpt2_block(y, pg, mask, num_heads=2),
        FG.fused_gpt2_block_plain(y, pg, mask, num_heads=2), rtol=0, atol=0)
    assert sum(launch_counts().values()) == 0
    assert sum(long_launch_counts().values()) == 0


CSRC = os.path.join(REPO, "afft_tpu_torch", "csrc")


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def test_length_rule_matches_the_kernels():
    """The Python rule's lengths are the CUDA sources' own: the short
    kernels' limits (``FR_MAX_N``, ``AS_MAX_N``, ``FS_MAX_KEYS``) and the
    long route's query count: the smallest query tile of either form's
    grids (``LA_TILE``, the tensor-core forms' 16-query strip) at most
    65,535 tiles, as the launchers check. Like the rule, neither launcher
    refuses a head width above 0: their checks bound hd from below only,
    and neither source names a largest hd."""
    def constant(source, name):
        m = re.search(rf"constexpr int {name} = (\d+);", _source(source))
        assert m, (source, name)
        return int(m.group(1))
    assert _common.SHORT_LENGTH == {
        "fuser": constant("fuser_attention.cuh", "FR_MAX_N"),
        "gpt2": constant("staged_attention.cuh", "AS_MAX_N"),
        "keys": constant("fuser_attention.cuh", "FS_MAX_KEYS")}
    tile = constant("long_attention.cuh", "LA_TILE")
    assert _common.LONG_MAX_QUERIES == 65535 * tile
    text = _source("long_attention.cu")
    assert "constexpr int LM_KT = LA_TILE;" in text
    assert "static constexpr int QT = 16 * MT" in text
    for grid in ("(a.Nq + LA_TILE - 1) / LA_TILE > 65535",
                 "(a.Nk + LA_TILE - 1) / LA_TILE > 65535"):
        assert grid in text
    assert not hasattr(_common, "LONG_MAX_HD")
    for source in ("long_attention.cuh", "long_attention.cu"):
        assert "MAX_HD" not in _source(source)
    for head in ("cudaError_t launch_long_attention(const LongAttn& a, "
                 "cudaStream_t", "cudaError_t launch_long_attention_bwd("
                 "const LongAttn& a,"):
        body = _body(text, head)
        checks = body[:body.index("return cudaErrorInvalidValue")]
        assert "a.hd < 1" in checks
        assert not re.search(r"\ba\.hd\s*(>|<=)", checks), checks


# Each entry's long route, by the instance it launches: launch_long_attention
# picks the tensor-core forms for bf16 with ROUND (the probabilities rounded:
# rows 2, 4-6, 11, 15) and the CUDA-core forms for fp32 and for the fuser's
# fp32 probabilities (rows 1, 7, 9)
LONG_ENTRIES = [
    ("fused_gpt2.cu", "launch_long_attention<T, true, false>"),        # 2
    ("fuser_attention.cuh", "launch_long_attention<T, true, false>"),  # 4-6
    ("fused_block.cu", "launch_long_attention<T, false, false>"),      # 1
    ("train_block.cuh", "launch_long_attention<T, GPT2, true>"),        # 7, 11
    ("train_block.cuh", "launch_long_attention_bwd<T, GPT2, true>"),    # 9, 15
]


@pytest.mark.parametrize("source, call", LONG_ENTRIES)
def test_long_route_entries(source, call):
    """Each entry reaches the long route through the dispatching launcher
    with its own cast chain (never a form's launcher directly)."""
    text = _source(source)
    assert call in text
    assert "launch_long_mma" not in text and "f32rows" not in text


def _body(text, head):
    start = text.index(head)
    return text[start:text.index("\n}\n", start)]


@pytest.mark.parametrize("head, mma, cuda_core", [
    ("cudaError_t launch_long_attention(const LongAttn& a, cudaStream_t",
     "launch_long_mma<DROP>(a, lm_rows_aligned(a, false), stream)",
     "launch_long_f32rows<T, ROUND, DROP>(a, stream)"),
    ("cudaError_t launch_long_attention_bwd(const LongAttn& a,",
     "launch_long_mma_bwd<DROP>(a, stream)",
     "launch_long_f32rows_bwd<T, ROUND, DROP>(a, stream)")])
def test_long_route_dispatch(head, mma, cuda_core):
    """The forward and the backward pick their form by type: bf16 with
    ROUND the tensor-core kernels, else the CUDA-core ones; no form falls
    back to another (the tensor-core launchers never reach the CUDA-core
    kernels)."""
    text = _source("long_attention.cu")
    body = _body(text, head)
    route = "if constexpr (std::is_same<T, bf16>::value && ROUND)"
    assert route in body
    assert body.index(route) < body.index(mma) < body.index(cuda_core)
    assert "try" not in body.split()
    for launcher in ("static cudaError_t launch_long_mma(",
                     "static cudaError_t launch_long_mma_bwd("):
        assert "f32rows" not in _body(text, launcher)
