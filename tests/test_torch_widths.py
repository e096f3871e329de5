"""The port at model widths off the 8-column grid, against the JAX package,
on the CPU.

The JAX package answers any C with H * hd = C and any MLP width: where its
Pallas kernels do not take a width (``pallas_block.supported`` and the
dispatch of its other kernels want multiples of 128) it takes its XLA
path, so the XLA path is the reference here. The port's kernels take these
widths on the card (the Hopper GEMM packs an operand whose rows are off
TMA's 16-byte grid, ``csrc/gemm_sm90.cuh``); on the CPU its wrappers run
their plain versions, which are held here:

- expt 99 (``expts/99_synth_smoke_{val,train}.txt``) with the fuser at C 25
  (5 heads of 5, MLP 100) and the GPT-2 predictor at C 27 (3 heads of 9, MLP
  108), built in both packages from the same seeded parameters (carried by
  ``weights.state_dict_from_jax``): every output of the eval forward (atol
  2e-5, rtol 1e-5, fp32, tests/test_parity.py's), every parameter's
  gradient of one training forward and one ``Runner.train_step``'s losses
  (1e-5);
- the plain versions of rows 1-3, 5-9 and 11-15 at C 20 (4 heads of 5) and
  C 36 (4 heads of 9) with MLP widths 36 and 100, on the short route and
  past it, against ``blocks.block_apply``, the predictor's ``_block``,
  ``blocks.decoder_block_apply`` and, for the training entries on explicit
  masks, ``block_reference_with_masks`` / ``gpt2_block_reference_with_masks``
  under ``jax.grad`` (tests/test_torch_ops.py's and
  tests/test_torch_train_ops.py's tolerances);
- ``ops.gemm`` / ``gemm_tn`` at those products' K, N, I and J;
- the tensor-parallel placement: a layer shards wherever JAX's
  ``shard_params`` shards its tensors (expt 99's fuser at tp = 2 at both
  widths);
- no ``% 8`` width refusal left in the launchers and wrappers.
"""

import inspect
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afft_tpu.config import compose as jax_compose
from afft_tpu.config import instantiate as jax_instantiate
from afft_tpu.models import BaseModel as JaxBaseModel
from afft_tpu.models import blocks as JB
from afft_tpu.models import layers as JL
from afft_tpu.models.predictor import BaseFuturePredictor as JaxPredictor
from afft_tpu.ops import pallas_block_train as PBT
from afft_tpu.ops import pallas_gpt2_train as PGT
from afft_tpu.parallel import sharding as JSH
from afft_tpu.train import optim as JO
from afft_tpu.train.mixup import MixUp as JaxMixUp
from afft_tpu.train.runner import Runner as JaxRunner
from afft_tpu_torch import weights as W
from afft_tpu_torch.config import CONF_DIR, compose, read_expt_file
from afft_tpu_torch.models import BaseModel
from afft_tpu_torch.ops import _common
from afft_tpu_torch.ops import fused_block as FB
from afft_tpu_torch.ops import fused_block_train as FT
from afft_tpu_torch.ops import fused_gpt2 as FG
from afft_tpu_torch.ops import fused_gpt2_train as FGT
from afft_tpu_torch.ops import fused_seq_block as FS
from afft_tpu_torch.ops import gemm as G
from afft_tpu_torch.ops import launch_counts, reset_launches
from afft_tpu_torch.train.runner import Runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_VAL = os.path.join(REPO, "expts", "99_synth_smoke_val.txt")
SMOKE_TRAIN = os.path.join(REPO, "expts", "99_synth_smoke_train.txt")
# the fuser at C 25 (5 heads of 5, MLP 100), GPT-2 at C 27 (3 heads of 9,
# MLP 108): both widths and both MLP widths off the 8-column grid
OFF_GRID = ["model.common_dim=25", "model.fuser.num_heads=5",
            "model.common.fp_inter_dim=27", "model.common.fp_heads=3"]
NO_DROPOUT = ["model.dropout=0.0", "model.fuser.embd_drop_rate=0.0",
              "model.fuser.drop_rate=0.0", "model.fuser.attn_drop_rate=0.0",
              "model.fuser.drop_path_rate=0.0", "model.common.embd_pdrop=0.0",
              "model.common.resid_pdrop=0.0", "model.common.attn_pdrop=0.0"]
CLASSES = {"action": 7, "verb": 3, "noun": 5}
ATOL, RTOL = 2e-5, 1e-5
BLOCK_TOL, GPT2_TOL = 2e-5, 3e-5
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
DX_TOL = dict(rtol=1e-4, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# (C, heads, MLP width): hd 5 and 9, every width off the 8-column grid
WIDTHS = [(20, 4, 36), (20, 4, 100), (36, 4, 36), (36, 4, 100)]


def _rng_tree(tree, rng):
    """numpy copy of a JAX param tree with every tensor moved off its init
    (the biases and affines are zeros and ones there)."""
    return jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(
        a.shape)).astype(np.float32), tree)


def _mlp(rng, C, hidden, names):
    """An MLP of ``hidden`` columns under the JAX ``names`` (in, out)."""
    return {names[0]: {"w": 0.1 * rng.standard_normal((C, hidden)),
                       "b": rng.standard_normal(hidden) * 0.05},
            names[1]: {"w": 0.1 * rng.standard_normal((hidden, C)),
                       "b": rng.standard_normal(C) * 0.05}}


def _jax_block(C, H, hidden, seed):
    rng = np.random.default_rng(seed)
    p = dict(JB.block_init(jax.random.key(seed), C, H, 4.0, True, True))
    p["mlp"] = _mlp(rng, C, hidden, ("fc1", "fc2"))
    return _rng_tree(p, rng)


def _jax_gpt2(C, hidden, seed):
    rng = np.random.default_rng(seed)
    k1, k2 = jax.random.split(jax.random.key(seed))
    p = {"ln_1": JL.layernorm_init(C),
         "c_attn": JL.normal_linear_init(k1, C, 3 * C, 0.02),
         "c_proj": JL.normal_linear_init(k2, C, C, 0.02),
         "ln_2": JL.layernorm_init(C)}
    mlp = _mlp(rng, C, hidden, ("c_fc", "mlp_c_proj"))
    return _rng_tree({**p, **mlp}, rng)


def _close(got, want, tol, name):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=name)


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# -- the entries' plain versions (rows 1-3, 5-9, 11-15) ------------------------

@pytest.mark.parametrize("C,H,hidden", WIDTHS)
def test_fused_block_off_grid_matches_jax(C, H, hidden):
    """Row 1 at 5 tokens and past the short route (12): against the JAX
    fuser block's XLA path, with the diagonal mask."""
    p = _jax_block(C, H, hidden, seed=C + hidden)
    params = W.block_from_jax(p)
    assert params["mlp.mlp.0.weight"].shape == (hidden, C)
    rng = np.random.default_rng(1)
    for N in (5, 12):
        x = _x(rng, 6, N, C)
        mask = JL.cross_attention_diag_mask(N)
        want, _ = JB.block_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                                 H, mask, norm_eps=1e-6, need_weights=False)
        got = FB.fused_block(torch.from_numpy(x), params,
                             torch.tensor(np.asarray(mask)), num_heads=H)
        _close(got, want, BLOCK_TOL, f"fused_block N={N}")


@pytest.mark.parametrize("C,H,hidden", WIDTHS)
def test_gpt2_halves_off_grid_match_jax(C, H, hidden):
    """Rows 2 and 3 at T 16 and past the short route (40): the halves, and
    the layer they compose, against the predictor's XLA layer."""
    p = _jax_gpt2(C, hidden, seed=C + hidden)
    jpred = JaxPredictor(in_features=C, inter_dim=C, n_layer=1, n_head=H)
    params = W.gpt2_block_from_jax(p, H)
    rng = np.random.default_rng(2)
    for T in (16, 40):
        x = _x(rng, 3, T, C)
        mask = JL.neg_inf_causal_mask(T, jnp.float32)
        want, _ = jpred._block(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                               mask, train=False, rng=None,
                               collect_attn=False)
        mask_t = torch.tensor(np.asarray(mask))
        y = FG.gpt2_attn_half(torch.from_numpy(x), params, mask_t,
                              num_heads=H)
        got = FG.gpt2_mlp_half(y, params)
        _close(got, want, GPT2_TOL, f"gpt2 halves T={T}")
        _close(FG.fused_gpt2_block(torch.from_numpy(x), params, mask_t,
                                   num_heads=H), got, 0.0, "composed")


@pytest.mark.parametrize("C,H,hidden", WIDTHS)
def test_seq_blocks_off_grid_match_jax(C, H, hidden):
    """Rows 5 and 6 over 10 tokens with the causal mask: the T-SA-Fuser
    block against ``block_apply``, the CA-Fuser's decoder block against
    ``decoder_block_apply``."""
    rng = np.random.default_rng(C * hidden)
    x, mem = _x(rng, 3, 10, C), _x(rng, 3, 10, C)
    mask = JL.neg_inf_causal_mask(10, jnp.float32)
    mask_t = torch.tensor(np.asarray(mask))
    p = _jax_block(C, H, hidden, seed=3)
    want, _ = JB.block_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), H,
                             mask, norm_eps=1e-6, need_weights=False)
    got = FS.fused_seq_block(torch.from_numpy(x), W.block_from_jax(p),
                             mask_t, num_heads=H)
    _close(got, want, BLOCK_TOL, "fused_seq_block")
    d = dict(JB.decoder_block_init(jax.random.key(4), C, None, H,
                                   qkv_bias=True))
    d["mlp"] = _mlp(np.random.default_rng(5), C, hidden, ("fc1", "fc2"))
    d = _rng_tree(d, np.random.default_rng(6))
    want = JB.decoder_block_apply(jax.tree.map(jnp.asarray, d),
                                  jnp.asarray(x), jnp.asarray(mem), H, mask)
    got = FS.fused_decoder_block(torch.from_numpy(x), torch.from_numpy(mem),
                                 W.decoder_block_from_jax(d), mask_t,
                                 num_heads=H)
    _close(got, want, BLOCK_TOL, "fused_decoder_block")


def _random_masks(shapes, kinds, rates, inv, rng):
    return tuple(torch.tensor(np.where(
        rng.random(shape) < 1 - rates[kind], np.float32(inv[kind]),
        np.float32(0))) for shape, kind in zip(shapes, kinds))


@pytest.mark.parametrize("C,H,hidden", WIDTHS)
def test_training_block_off_grid_matches_jax(C, H, hidden):
    """Rows 7-9: the fuser's training block on random explicit masks,
    forward, dx and every parameter gradient, against
    ``block_reference_with_masks`` under ``jax.grad`` (the JAX kernel's
    per-tile mask layout)."""
    R, N = 6, 5
    rates = (0.3, 0.2, 0.4)
    rng = np.random.default_rng(7)
    _, inv = FT.rates_operands(*rates)
    masks = _random_masks(FT._mask_shapes(R, N, C, H), FT._RATE_OF_SITE,
                          rates, inv, rng)
    p = _jax_block(C, H, hidden, seed=8)
    x_np, cot_np = _x(rng, R, N, C), _x(rng, R, N, C)
    mattn, mproj, dp1, mmlp, dp2 = (m.numpy() for m in masks)
    attn = np.zeros((1, R, PBT._attn_bits_width(H, N)), np.float32)
    attn[0, :, :N * N * H] = mattn.transpose(0, 2, 3, 1).reshape(R, -1)

    def rows(m):
        return m.reshape(R, N, C).transpose(1, 0, 2).reshape(1, N * R, C)

    def dp(m):
        return np.repeat(m.reshape(1, R, 1), 128, axis=2)
    jmasks = tuple(jnp.asarray(a) for a in (attn, rows(mproj), dp(dp1),
                                            rows(mmlp), dp(dp2)))
    zero = jnp.zeros((N, N), jnp.float32)

    def ref(x, q):
        return PBT.block_reference_with_masks(x, q, zero, jmasks,
                                              num_heads=H, eps=1e-6)
    jp = jax.tree.map(jnp.asarray, p)
    x_tm = jnp.asarray(x_np.transpose(1, 0, 2))
    cot_tm = jnp.asarray(cot_np.transpose(1, 0, 2))
    want = ref(x_tm, jp)
    gx, gp = jax.grad(lambda x, q: jnp.sum(ref(x, q) * cot_tm),
                      argnums=(0, 1))(x_tm, jp)
    x = torch.tensor(x_np, requires_grad=True)
    tp = {k: v.clone().requires_grad_(True)
          for k, v in W.block_from_jax(p).items()}
    out = FT.fused_block_train_plain(x, tp, None, masks, num_heads=H)
    out.backward(torch.tensor(cot_np))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(want).transpose(1, 0, 2), **FWD_TOL)
    np.testing.assert_allclose(x.grad.numpy(),
                               np.asarray(gx).transpose(1, 0, 2), **DX_TOL)
    ref_grads = W.block_from_jax(jax.tree.map(np.asarray, gp))
    assert set(ref_grads) == set(tp)
    for name, want_g in ref_grads.items():
        np.testing.assert_allclose(tp[name].grad.numpy(), want_g.numpy(),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("C,H,hidden", WIDTHS)
def test_gpt2_training_layer_off_grid_matches_jax(C, H, hidden):
    """Rows 11-15: the GPT-2 training layer on random explicit masks,
    forward, dx and the twelve gradients, against
    ``gpt2_block_reference_with_masks`` under ``jax.grad``."""
    B, T = 3, 7
    rates = (0.3, 0.2)
    rng = np.random.default_rng(9)
    _, inv = FGT.rates_operands(*rates)
    masks = _random_masks(FGT.mask_shapes(B, T, C, H), FGT._RATE_OF_SITE,
                          rates, inv, rng)
    mattn, mproj, mmlp = (m.numpy() for m in masks)
    attn = np.zeros((1, B * T, 128), np.float32)
    attn[0, :, :H * T] = mattn.transpose(0, 2, 1, 3).reshape(B * T, H * T)
    jmasks = tuple(jnp.asarray(a) for a in (attn, mproj[None], mmlp[None]))
    p = _jax_gpt2(C, hidden, seed=10)
    x_np, cot_np = _x(rng, B, T, C), _x(rng, B, T, C)
    mask = np.asarray(JL.neg_inf_causal_mask(T, jnp.float32))

    def ref(x, q):
        return PGT.gpt2_block_reference_with_masks(
            x, q, jnp.asarray(mask), jmasks, num_heads=H)
    jp = jax.tree.map(jnp.asarray, p)
    want = ref(jnp.asarray(x_np), jp)
    gx, gp = jax.grad(lambda x, q: jnp.sum(ref(x, q) * jnp.asarray(cot_np)),
                      argnums=(0, 1))(jnp.asarray(x_np), jp)
    x = torch.tensor(x_np, requires_grad=True)
    tp = {k: v.clone().requires_grad_(True)
          for k, v in W.gpt2_block_from_jax(p, H).items()}
    out = FGT.fused_gpt2_block_train_plain(x, tp, torch.tensor(mask), masks,
                                           num_heads=H)
    out.backward(torch.tensor(cot_np))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), **DX_TOL)
    ref_grads = W.gpt2_block_from_jax(jax.tree.map(np.asarray, gp), H)
    assert set(ref_grads) == set(FGT.KEYS)
    for name in FGT.KEYS:
        np.testing.assert_allclose(tp[name].grad.numpy(),
                                   ref_grads[name].numpy(), err_msg=name,
                                   **GRAD_TOL)


# -- the GEMM's plain versions at expt 99's off-grid products ------------------

# (N, K) of the products of the fuser at C 25 / MLP 100 (qkv, proj, fc1,
# fc2) and of GPT-2 at C 27 / MLP 108 (c_attn, c_proj, c_fc, mlp c_proj)
OFF_GRID_PRODUCTS = [(75, 25), (25, 25), (100, 25), (25, 100), (81, 27),
                     (27, 27), (108, 27), (27, 108)]


@pytest.mark.parametrize("N,K", OFF_GRID_PRODUCTS)
def test_gemm_off_grid_products_match_jax(N, K):
    """``gemm`` on both weight layouts with the bias and the residual add,
    and ``gemm_tn`` (the weight gradient of the product), at 37 rows:
    against JAX's products of the same bf16 operands in fp32."""
    rng = np.random.default_rng(N * K)

    def bf16(*shape):
        return torch.from_numpy(_x(rng, *shape)).bfloat16()
    M = 37
    a, w, b, r = bf16(M, K), bf16(K, N), bf16(N), bf16(M, N)
    f32 = [jnp.asarray(t.float().numpy()) for t in (a, w, b, r)]
    acc = jnp.dot(f32[0], f32[1], precision=jax.lax.Precision.HIGHEST)
    for epi, want in (("bias", acc + f32[2]), ("bias_res", f32[3] + (acc +
                                                                     f32[2]))):
        want = np.asarray(want.astype(jnp.bfloat16).astype(jnp.float32))
        for w_in_out in (True, False):
            got, _ = G.gemm(a, w if w_in_out else w.t().contiguous(), epi, b,
                            r, w_in_out=w_in_out)
            np.testing.assert_allclose(got.float().numpy(), want,
                                       rtol=2 ** -7, atol=1e-6,
                                       err_msg=f"{epi} w_in_out={w_in_out}")
    dy = bf16(M, N)
    want = jnp.dot(f32[0].T, jnp.asarray(dy.float().numpy()),
                   precision=jax.lax.Precision.HIGHEST)
    np.testing.assert_allclose(G.gemm_tn(a, dy).numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-5)


def test_pack_rows_plain_copies_rows_to_a_padded_stride():
    """The pack kernel's plain version: the (rows, cols) view of a
    (rows, pad8(cols)) buffer equal to x, the padding columns zero."""
    x = torch.arange(3 * 25, dtype=torch.float32).reshape(3, 25).bfloat16()
    got = G.pack_rows(x)
    assert got.shape == (3, 25) and got.stride() == (32, 1)
    assert torch.equal(got, x)
    assert torch.equal(got.as_strided((3, 32), (32, 1))[:, 25:],
                       torch.zeros(3, 7).bfloat16())
    assert G.pack_rows(x[:, :16].contiguous()).stride() == (16, 1)


def _packs(M, a, b, layout):
    """The elements the Hopper GEMM packs for one product on an (a, b)
    weight over M rows (``tma_operand``: an operand whose rows are off the
    8-column grid goes to rows of pad8 columns): "fwd" / "dx" read an M-row
    input of b / a columns and the weight, "grad" two M-row operands."""
    def packed(rows, cols):
        return rows * _common.pad8(cols) if cols % 8 else 0
    if layout == "grad":
        return packed(M, a) + packed(M, b)
    return packed(M, b if layout == "fwd" else a) + packed(a, b)


def test_pack_arena_sizes_cover_every_product():
    """``pack_scratch``: no arena in fp32 or where every width is a multiple
    of 8; else (2 M + w) pad8(w) for the largest width w, which holds every
    product the entries run (forward, dX, weight gradient) on each of a
    layer's weights, in either layout, at expt 99's off-grid widths, at
    full width and on a shard."""
    t = torch.zeros(2, 3, 25)
    assert _common.pack_scratch(t, 6, 25, 75, 100) is None      # fp32
    t = t.bfloat16()
    assert _common.pack_scratch(t, 20480, 1024, 3072, 4096) is None
    assert _common.pad8(25) == 32 and _common.pad8(32) == 32
    pack = _common.pack_scratch(t, 10, 25, 100)
    assert pack.dtype == torch.bfloat16 and pack.numel() == (20 + 100) * 104
    for M, C, A, hidden in ((6, 25, 25, 100), (1920, 27, 9, 108),
                            (20480, 1025, 1025, 4100), (4096, 36, 18, 50)):
        n = _common.pack_scratch(t, M, C, 3 * A, hidden).numel()
        weights = [(3 * A, C), (C, A), (hidden, C), (C, hidden)]
        # the fuser's nn.Linear (out, in) weights and GPT-2's Conv1D (in,
        # out) ones: the same products on the transposed storage
        for a, b in weights + [(b, a) for a, b in weights]:
            assert all(_packs(M, a, b, layout) <= n
                       for layout in ("fwd", "dx", "grad"))


# -- placement and the sources -------------------------------------------------

@pytest.mark.parametrize("overrides", [[], OFF_GRID], ids=["c24", "c25"])
def test_fuser_shards_where_jax_places_shards(overrides):
    """At tp = 2 each SA-Fuser block of expt 99 shards in the port exactly
    where JAX's ``shard_params`` shards its fc1 / fc2 (the MLP width
    divides): at C 24 (MLP 96) and at C 25 (MLP 100, local 50), which the
    port kept whole while its kernels needed hidden / tp % 8 == 0."""
    tcfg = compose(CONF_DIR, read_expt_file(SMOKE_TRAIN) + overrides)
    jcfg = jax_compose(os.path.join(REPO, "afft_tpu", "conf"),
                       read_expt_file(SMOKE_TRAIN) + overrides)
    params = JaxBaseModel(jcfg.model, num_classes=CLASSES).init(
        jax.random.key(0))
    jax_sharded = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        name = JSH._path_str(path)
        m = re.match(r".*fuser\.blocks\.(\d+)\.mlp\.fc[12]\.w$", name)
        if m:
            spec = JSH.spec_for_path(name)
            dim = [d for d, axis in enumerate(spec) if axis == "model"][0]
            jax_sharded.setdefault(int(m.group(1)), []).append(
                leaf.shape[dim] % 2 == 0)
    assert len(jax_sharded) == int(tcfg.model.fuser.depth)
    model = BaseModel(tcfg.model, num_classes=CLASSES)
    fusers = [mod for _, mod in model.named_modules()
              if hasattr(mod, "tp_blocks") and hasattr(mod, "num_heads")]
    assert len(fusers) == 1
    for i, _, why, _ in fusers[0].tp_blocks(2):
        assert all(jax_sharded[i]) and why is None, (i, why)
    hidden = 4 * int(tcfg.model.common_dim)
    assert _common.shard_reason(int(tcfg.model.common_dim),
                                int(tcfg.model.fuser.num_heads), hidden, 2,
                                split_heads=False) is None
    # a dimension that does not divide still keeps the layer whole, as JAX
    # keeps its tensors whole
    assert "does not divide" in _common.shard_reason(25, 5, 101, 2, False)
    assert "heads" in _common.shard_reason(27, 3, 108, 2)


def test_no_width_gate_is_left():
    """No ``% 8`` refusal of a width in the shape rule, the shard rule, the
    GPT-2 MLP half, the GEMM's wrappers or its launchers (the GEMM's only
    remaining ``% 8`` tests choose its routes: TMA as the operand lies or
    packed, the 16-byte epilogue or the element-wise one)."""
    for fn in (_common.check_heads, _common.shard_reason, FG.gpt2_mlp_half,
               G.gemm, G.gemm_tn):
        assert "% 8" not in inspect.getsource(fn), fn.__name__
    src = open(os.path.join(REPO, "afft_tpu_torch", "csrc",
                            "gemm_sm90.cuh")).read()
    for launcher in ("launch_gemm_sm90", "launch_gemm_tn_sm90"):
        body = src[src.index(f"static cudaError_t {launcher}("):]
        body = body[:body.index("\n}\n")]
        refusals = re.findall(r"if \(([^;]*?)\)\s*return cudaErrorInvalidValue",
                              body, re.S)
        assert refusals, launcher
        assert not any("% 8" in r for r in refusals), (launcher, refusals)
    for name in ("fused_block.cu", "fused_gpt2.cu", "seq_block.cu",
                 "fused_block_train.cu", "fused_gpt2_train.cu",
                 "train_block.cuh"):
        text = open(os.path.join(REPO, "afft_tpu_torch", "csrc", name)).read()
        assert "C % 8 == 0" not in text and "hidden % 8 == 0" not in text, \
            name


# -- expt 99 at C 25 / 27 through both packages --------------------------------

def _configs(path, more=()):
    overrides = read_expt_file(path) + OFF_GRID + list(more)
    return (jax_compose(os.path.join(REPO, "afft_tpu", "conf"), overrides),
            compose(CONF_DIR, overrides))


def _features(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    T = int(cfg.data_eval.num_frames)
    return {m: _x(rng, batch, T, int(d))
            for m, d in cfg.model.modal_dims.to_container().items()}


def _flatten(out, prefix=""):
    flat = {}
    for k, v in out.items():
        if isinstance(v, dict):
            flat.update(_flatten(v, f"{prefix}{k}//"))
        elif v is not None:
            flat[prefix + k] = np.asarray(v)
    return flat


def _models(jcfg, tcfg, seed=7):
    jmodel = JaxBaseModel(jcfg.model, num_classes=CLASSES)
    jparams = jmodel.init(jax.random.key(seed))
    model = BaseModel(tcfg.model, num_classes=CLASSES)
    model.load_state_dict(W.state_dict_from_jax(
        model, jax.tree.map(np.asarray, jparams)), strict=True)
    return jmodel, jparams, model


def test_expt99_off_grid_serves_as_jax():
    """Every output of the eval forward (fuser C 25, GPT-2 C 27) against
    JAX ``BaseModel.apply`` on the same weights; on the CPU the plain
    versions run and no kernel launches."""
    jcfg, tcfg = _configs(SMOKE_VAL)
    assert int(tcfg.model.common_dim) == 25
    assert int(tcfg.model.common.fp_inter_dim) == 27
    jmodel, jparams, model = _models(jcfg, tcfg)
    feats = _features(tcfg, 4, seed=11)
    want = jax.jit(lambda p, f: jmodel.apply(p, f)[0])(
        jparams, {m: jnp.asarray(v) for m, v in feats.items()})
    reset_launches()
    with torch.no_grad():
        got = model.eval()({m: torch.from_numpy(v) for m, v in feats.items()})
    assert sum(launch_counts().values()) == 0
    want = {k: v for k, v in _flatten(want).items()
            if not k.startswith("attentions//")}
    got = _flatten({k: v for k, v in got.items() if k != "attentions"})
    assert set(got) == set(want)
    assert any(k.startswith("logits/") for k in got)
    for key in sorted(want):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=ATOL,
                                   err_msg=key)


def _scalar(out):
    return sum((out[k]["all-fused"] ** 2).sum() for k in out
               if "logits/" in k or k == "past_futures")


def test_expt99_off_grid_gradients_match_jax():
    """One backward of the training forward (every rate 0) in both
    packages: every parameter's gradient at rtol 1e-5 plus 1e-5 of that
    gradient's largest magnitude."""
    jcfg, tcfg = _configs(SMOKE_TRAIN, NO_DROPOUT)
    jmodel, jparams, model = _models(jcfg, tcfg, seed=3)
    feats = _features(tcfg, 4, seed=12)
    want = jax.jit(jax.grad(lambda p, f: _scalar(jmodel.apply(
        p, f, train=True, rng=None)[0])))(
            jparams, {m: jnp.asarray(v) for m, v in feats.items()})
    model.train()
    _scalar(model({m: torch.from_numpy(v) for m, v in feats.items()})
            ).backward()
    want = W.grads_from_jax(model, jax.tree.map(np.asarray, want))
    reached = 0
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        reached += p.grad is not None
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(ref).max(), 1.0),
                                   err_msg=name)
    assert reached > len(want) // 2


def test_expt99_off_grid_runner_step_matches_jax():
    """One ``Runner.train_step`` (mixup on, every dropout rate 0) against
    the JAX runner's from the same weights and batch: every loss component
    at rtol 1e-5 (atol 1e-6)."""
    jcfg, tcfg = _configs(SMOKE_TRAIN, NO_DROPOUT)
    rng = np.random.default_rng(0)
    T, B = int(tcfg.data_train.num_frames), 4
    batch = {"data_dict": _features(tcfg, B, seed=13),
             "target": {t: rng.integers(0, c, (B,))
                        for t, c in CLASSES.items()},
             "target_subclips": {t: rng.integers(0, c, (B, T, 1))
                                 for t, c in CLASSES.items()},
             "valid": np.ones((B,), bool), "mixup_lam": np.float32(0.35)}
    lr = float(tcfg.opt.lr)
    jmodel = JaxBaseModel(jcfg.model, num_classes=CLASSES)
    params = jmodel.init(jax.random.key(3))
    params0 = jax.tree.map(np.asarray, params)
    groups = JO.build_group_tree(params, jcfg.opt.lr_wd, jcfg.opt.lr,
                                 jcfg.opt.wd)
    joptimizer = jax_instantiate(jcfg.opt.optimizer)
    jrunner = JaxRunner(
        jmodel, joptimizer, groups,
        loss_wts=dict(jcfg.train.loss_wts.items()),
        mixup=JaxMixUp(alpha=jcfg.train.mixup_alpha,
                       label_smoothing=dict(
                           jcfg.train.label_smoothing.items()),
                       num_classes=CLASSES),
        mixup_backbone=jcfg.train.mixup_backbone,
        grad_clip=jcfg.opt.grad_clip, donate=False)
    _, _, want, _, _ = jrunner.train_step(
        params, joptimizer.init(params, groups),
        {**batch, "mixup_lam": jnp.asarray(batch["mixup_lam"])}, lr, lr,
        jax.random.key(0))
    runner = Runner.from_config(tcfg, CLASSES, device="cpu",
                                iters_per_epoch=1)
    runner.model.load_state_dict(
        W.state_dict_from_jax(runner.model, params0), strict=True)
    reset_launches()
    got, _ = runner.train_step(batch, lr, lr, check_nan=True)
    assert not any(launch_counts().values())
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
