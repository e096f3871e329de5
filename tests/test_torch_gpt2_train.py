"""The GPT-2 training layer of the port against the JAX package, on the CPU.

``ops.fused_gpt2_train.fused_gpt2_block_train`` on CPU tensors runs its plain
version, whose backward is the backward kernels' plain version
(``fused_block_train.block_train_bwd_plain``) under torch.autograd. The
references are the JAX package's own:
``pallas_gpt2_train.fused_gpt2_block_train`` in interpret mode (custom VJP
through the Pallas backward kernels and the XLA dW / db products),
``pallas_gpt2_train.gpt2_block_reference_with_masks`` and
``BaseFuturePredictor._block(train=False)`` under ``jax.grad``. Inputs come
from numpy seeds; fp32 but in the bf16 cast-chain tests. Parameters and
gradients cross over through ``weights.gpt2_block_from_jax`` (c_attn
re-interleaved from the JAX heads-major packing to [q | k | v]).

Tolerances (only the summation order differs between the two frameworks):
forward 2e-5; dx rtol 1e-4, atol 2e-5; parameter gradients rtol 1e-4, atol
1e-4 (sums over up to 64 rows of O(1) terms), the bounds of
tests/test_torch_train_ops.py for the fuser's training block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afft_tpu.models import layers as JL
from afft_tpu.models.predictor import BaseFuturePredictor as JaxPredictor
from afft_tpu.ops import pallas_gpt2_train as PGT
from afft_tpu_torch import weights as W
from afft_tpu_torch.models import layers as L
from afft_tpu_torch.models.predictor import BaseFuturePredictor
from afft_tpu_torch.ops import fused_block_train as FT
from afft_tpu_torch.ops import fused_gpt2 as FG
from afft_tpu_torch.ops import fused_gpt2_train as FGT
from afft_tpu_torch.ops import launch_counts, reset_launches

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
DX_TOL = dict(rtol=1e-4, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
SEEDS = (1234, 567)


def _jax_layer(C, seed=0):
    """A JAX GPT-2 layer (heads-major c_attn) with every tensor away from
    its init value (biases and LayerNorm affines are zeros and ones at
    init)."""
    k1, k2, k3, k4 = jax.random.split(jax.random.key(seed), 4)
    params = {"ln_1": JL.layernorm_init(C),
              "c_attn": JL.normal_linear_init(k1, C, 3 * C, 0.02),
              "c_proj": JL.normal_linear_init(k2, C, C, 0.02),
              "ln_2": JL.layernorm_init(C),
              "c_fc": JL.normal_linear_init(k3, C, 4 * C, 0.02),
              "mlp_c_proj": JL.normal_linear_init(k4, 4 * C, C, 0.02)}
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32)), params)


def _inputs(B, T, C, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, C)).astype(np.float32),
            rng.standard_normal((B, T, C)).astype(np.float32))


def _causal(T):
    return np.triu(np.full((T, T), -np.inf, np.float32), k=1)


def _torch_grads(fn, x_np, params_np, H, cot_np):
    """(out, dx, {name: grad}) of sum(fn(x, params) * cot) in the port."""
    x = torch.tensor(x_np, requires_grad=True)
    p = {k: v.clone().requires_grad_(True)
         for k, v in W.gpt2_block_from_jax(params_np, H).items()}
    out = fn(x, p)
    out.backward(torch.tensor(cot_np))
    return out.detach().numpy(), x.grad.numpy(), \
        {k: v.grad for k, v in p.items()}


def _jax_grads(fn, x_np, params, cot_np):
    x = jnp.asarray(x_np)
    out = fn(x, params)
    gx, gp = jax.grad(lambda x, p: jnp.sum(fn(x, p) * jnp.asarray(cot_np)),
                      argnums=(0, 1))(x, params)
    return np.asarray(out), np.asarray(gx), gp


def _assert_match(got, want, H, where):
    """Output, dx and the twelve gradients (through the heads-major ->
    [q | k | v] permutation) against the JAX ones."""
    out, dx, grads = got
    w_out, w_dx, w_grads = want
    np.testing.assert_allclose(out, w_out, err_msg=where, **FWD_TOL)
    np.testing.assert_allclose(dx, w_dx, err_msg=where, **DX_TOL)
    ref = W.gpt2_block_from_jax(jax.tree.map(np.asarray, w_grads), H)
    assert set(grads) == set(ref) == set(FGT.KEYS)
    for name in FGT.KEYS:
        assert grads[name] is not None, f"{where}: no gradient for {name}"
        np.testing.assert_allclose(grads[name].numpy(), ref[name].numpy(),
                                   err_msg=f"{where}: {name}", **GRAD_TOL)


@pytest.mark.parametrize("B,T,C,H", [(4, 4, 128, 1), (2, 8, 256, 2)])
def test_zero_rates_match_pallas_vjp(B, T, C, H):
    """Rates 0 at widths the Pallas kernel takes (head_dim 128): the output,
    dx and every parameter gradient against the Pallas custom VJP in
    interpret mode; and the training layer with rates 0 is the serving
    layer."""
    params = _jax_layer(C)
    x_np, cot_np = _inputs(B, T, C)
    mask = _causal(T)

    def pallas(x, p):
        return PGT.fused_gpt2_block_train(
            x, p, jnp.asarray(mask), jnp.asarray(SEEDS, jnp.int32),
            num_heads=H, layer_idx=2, block_b=B, interpret=True)
    want = _jax_grads(pallas, x_np, params, cot_np)
    reset_launches()
    params_np = jax.tree.map(np.asarray, params)
    got = _torch_grads(
        lambda x, p: FGT.fused_gpt2_block_train(
            x, p, torch.tensor(mask), SEEDS, num_heads=H, layer_idx=2),
        x_np, params_np, H, cot_np)
    assert sum(launch_counts().values()) == 0    # CPU: the plain version
    _assert_match(got, want, H, "vs the Pallas VJP")
    serving = FG.fused_gpt2_block(torch.tensor(x_np), W.gpt2_block_from_jax(
        params_np, H), torch.tensor(mask), num_heads=H)
    np.testing.assert_allclose(got[0], serving.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("rates", [(0.1, 0.2), (0.5, 0.0)])
def test_nonzero_rates_keep_all_masks_match_pallas_vjp(rates):
    """Under the interpreter the TPU generator draws zeros, so the Pallas
    kernel's masks keep everything scaled by 1 / keep. The port's plain
    version fed the same masks must give the same output and gradients:
    that holds the scale at the three sites."""
    B, T, C, H = 4, 4, 128, 1
    params = _jax_layer(C, seed=5)
    x_np, cot_np = _inputs(B, T, C, seed=6)
    mask = _causal(T)

    def pallas(x, p):
        return PGT.fused_gpt2_block_train(
            x, p, jnp.asarray(mask), jnp.asarray(SEEDS, jnp.int32),
            num_heads=H, layer_idx=1, block_b=2, interpret=True,
            attn_rate=rates[0], resid_rate=rates[1])
    want = _jax_grads(pallas, x_np, params, cot_np)
    _, inv = FGT.rates_operands(*rates)
    masks = tuple(torch.full(shape, float(np.float32(inv[kind])))
                  for shape, kind in zip(FGT.mask_shapes(B, T, C, H),
                                         FGT._RATE_OF_SITE))
    got = _torch_grads(
        lambda x, p: FGT.fused_gpt2_block_train_plain(
            x, p, torch.tensor(mask), masks, num_heads=H),
        x_np, jax.tree.map(np.asarray, params), H, cot_np)
    _assert_match(got, want, H, "keep-all masks vs the Pallas VJP")
    # the scales matter: with rates 0 the output differs
    zero = FGT.fused_gpt2_block_train(
        torch.tensor(x_np), W.gpt2_block_from_jax(
            jax.tree.map(np.asarray, params), H), torch.tensor(mask), SEEDS,
        num_heads=H)
    assert not np.allclose(got[0], zero.numpy(), atol=1e-3)


def test_bf16_forward_follows_the_pallas_cast_chain():
    """bf16: the plain version's output and its stashed y, qkv and pre1
    against the Pallas forward kernels in interpret mode (keep-all masks at
    rates 0.1 / 0.2): the same roundings at the same places, so at least
    99% of the elements are the same bits and none is further off than one
    bf16 ulp of the largest (2^-7 of max|ref|)."""
    B, T, C, H = 4, 8, 128, 1
    rates = (0.1, 0.2)
    params = _jax_layer(C, seed=5)
    x_np, _ = _inputs(B, T, C, seed=6)
    mask = _causal(T)
    bf = jnp.bfloat16
    flat = PGT._flat_params(params, C, 4 * C, bf)
    y, qkv, out, pre1 = PGT._fwd_calls(
        jnp.asarray(x_np).astype(bf), flat, jnp.asarray(mask),
        PGT._seeds_operand(jnp.asarray(SEEDS, jnp.int32), 1),
        *PGT._rates_operands(*rates, 0.0), num_heads=H, eps=1e-5,
        block_b=B, interpret=PGT._interpret_params(True))
    qkv = np.asarray(qkv.astype(jnp.float32)).reshape(
        B * T, H, 3, C // H).transpose(0, 2, 1, 3).reshape(B * T, 3 * C)
    _, inv = FGT.rates_operands(*rates)
    masks = tuple(torch.full(shape, float(np.float32(inv[kind])))
                  for shape, kind in zip(FGT.mask_shapes(B, T, C, H),
                                         FGT._RATE_OF_SITE))
    p = {k: v.to(torch.bfloat16) for k, v in W.gpt2_block_from_jax(
        jax.tree.map(np.asarray, params), H).items()}
    got = FGT.fused_gpt2_block_train_plain(
        torch.tensor(x_np).to(torch.bfloat16), p, torch.tensor(mask), masks,
        num_heads=H, return_residuals=True)
    wants = [np.asarray(a.astype(jnp.float32)).reshape(g.shape)
             for a, g in zip((out, y), got)] + [qkv, np.asarray(
                 pre1.astype(jnp.float32))]
    for name, g, want in zip(("out", "y", "qkv", "pre1"), got, wants):
        assert g.dtype == torch.bfloat16, name
        diff = np.abs(g.float().numpy() - want)
        assert (diff == 0).mean() >= 0.99, name
        assert diff.max() <= 2.0 ** -7 * np.abs(want).max(), name


def test_bf16_gradients_follow_the_pallas_cast_chain():
    """bf16 at rates 0 (B 4, T 4, C 128, H 1): the plain version's output,
    dx and every parameter gradient (its backward
    ``block_train_bwd_plain`` with the GPT-2 layer's cast chain) against
    the Pallas custom VJP in interpret mode, per tensor within 8e-3 of the
    tensor's max |value| (two bf16 ulps): only the order of fp32 sums
    differs. Worst reading 3.1e-3 (``attn.c_attn.weight``). Plain autograd
    through the same forward, which rounds where the forward's casts lie,
    strays further (6.6e-3)."""
    B, T, C, H = 4, 4, 128, 1
    bf = jnp.bfloat16
    params = jax.tree.map(lambda a: a.astype(bf), _jax_layer(C, seed=3))
    x_np, cot_np = _inputs(B, T, C, seed=4)
    mask = _causal(T)

    def pallas(x, p):
        return PGT.fused_gpt2_block_train(
            x, p, jnp.asarray(mask), jnp.asarray(SEEDS, jnp.int32),
            num_heads=H, layer_idx=2, block_b=B,
            interpret=PGT._interpret_params(True))

    def f32(a):
        return np.asarray(jnp.asarray(a).astype(jnp.float32))
    xb = jnp.asarray(x_np).astype(bf)
    gx, gp = jax.grad(
        lambda x, p: jnp.sum(pallas(x, p).astype(jnp.float32)
                             * jnp.asarray(cot_np)), argnums=(0, 1))(xb, params)
    refs = {"out": f32(pallas(xb, params)), "dx": f32(gx),
            **{k: v.numpy() for k, v in W.gpt2_block_from_jax(
                jax.tree.map(f32, gp), H).items()}}
    assert len(refs) == 2 + len(FGT.KEYS)
    masks = FGT.draw_masks_gpt2_plain(B, T, C, H, SEEDS, 2, 0.0, 0.0)

    def worst(fn):
        """The largest per-tensor distance of ``fn``'s output, dx and
        gradients from the Pallas VJP's, over max|ref|."""
        x = torch.tensor(f32(xb)).to(torch.bfloat16).requires_grad_(True)
        p = {k: v.to(torch.bfloat16).requires_grad_(True) for k, v in
             W.gpt2_block_from_jax(jax.tree.map(f32, params), H).items()}
        out = fn(x, p)
        out.float().backward(torch.tensor(cot_np))
        got = {"out": out.detach(), "dx": x.grad,
               **{k: v.grad for k, v in p.items()}}
        assert set(got) == set(refs)
        return max((np.abs(got[k].float().numpy() - ref).max()
                    / np.abs(ref).max(), k) for k, ref in refs.items())
    kernels_chain = worst(lambda x, p: FGT.fused_gpt2_block_train_plain(
        x, p, torch.tensor(mask), masks, num_heads=H))
    assert kernels_chain[0] <= 8e-3, kernels_chain
    autograd = worst(lambda x, p: FGT._gpt2_train_fwd_plain(
        x, p, torch.tensor(mask), masks, H, 1e-5)[0])
    assert kernels_chain[0] < autograd[0], (kernels_chain, autograd)


def masks_to_jax_tile(masks, B, T, C, H):
    """The port's per-element masks -> the JAX kernel's single-tile layout
    (``draw_masks_gpt2`` with block_b = B): attention (1, B * T, 128) with
    the keep of (b, h, tq, tk) at row b * T + tq, lane h * T + tk; proj and
    MLP (1, B * T, C), rows b * T + t as here."""
    mattn, mproj, mmlp = (m.numpy() for m in masks)
    attn = np.zeros((1, B * T, 128), np.float32)
    attn[0, :, :H * T] = mattn.transpose(0, 2, 1, 3).reshape(B * T, H * T)
    return tuple(jnp.asarray(a) for a in (attn, mproj[None], mmlp[None]))


@pytest.mark.parametrize("B,T,C,H", [(4, 4, 128, 1), (3, 16, 64, 4)])
def test_random_explicit_masks_match_jax_reference(B, T, C, H):
    """Random 0 / (1 / keep) masks from numpy, converted to the JAX kernel's
    per-tile layout, through ``gpt2_block_reference_with_masks`` + jax.grad
    and through ``fused_gpt2_block_train_plain`` + autograd."""
    rates = (0.3, 0.2)
    rng = np.random.default_rng(7)
    _, inv = FGT.rates_operands(*rates)
    masks = tuple(
        torch.tensor(np.where(rng.random(shape) < 1 - rates[kind],
                              np.float32(inv[kind]), np.float32(0)))
        for shape, kind in zip(FGT.mask_shapes(B, T, C, H),
                               FGT._RATE_OF_SITE))
    assert all(0 < float((m == 0).float().mean()) < 1 for m in masks)
    params = _jax_layer(C, seed=8)
    x_np, cot_np = _inputs(B, T, C, seed=9)
    mask = _causal(T)
    jmasks = masks_to_jax_tile(masks, B, T, C, H)

    def ref(x, p):
        return PGT.gpt2_block_reference_with_masks(
            x, p, jnp.asarray(mask), jmasks, num_heads=H)
    want = _jax_grads(ref, x_np, params, cot_np)
    got = _torch_grads(
        lambda x, p: FGT.fused_gpt2_block_train_plain(
            x, p, torch.tensor(mask), masks, num_heads=H),
        x_np, jax.tree.map(np.asarray, params), H, cot_np)
    _assert_match(got, want, H, "random masks vs gpt2_block_reference")


@pytest.mark.parametrize("T", [5, 16])
def test_zero_rates_match_predictor_block_small_heads(T):
    """C 64, 4 heads of 16 (a width the Pallas kernel does not take):
    against the JAX predictor's XLA layer ``_block(train=False)``."""
    B, C, H = 3, 64, 4
    params = _jax_layer(C, seed=10)
    x_np, cot_np = _inputs(B, T, C, seed=11)
    jpred = JaxPredictor(in_features=C, inter_dim=C, n_layer=1, n_head=H)
    jmask = JL.neg_inf_causal_mask(T, jnp.float32)

    def xla(x, p):
        return jpred._block(p, x, jmask, train=False, rng=None,
                            collect_attn=False)[0]
    want = _jax_grads(xla, x_np, params, cot_np)
    got = _torch_grads(
        lambda x, p: FGT.fused_gpt2_block_train(
            x, p, L.neg_inf_causal_mask(T), SEEDS, num_heads=H, layer_idx=3),
        x_np, jax.tree.map(np.asarray, params), H, cot_np)
    _assert_match(got, want, H, "vs predictor._block")


# -- the mask generator -------------------------------------------------------

ARGS = dict(B=8, T=5, C=48, num_heads=4)


def _draw(seeds=SEEDS, layer_idx=1, rates=(0.1, 0.2), **kw):
    return FGT.draw_masks_gpt2_plain(*{**ARGS, **kw}.values(), seeds,
                                     layer_idx, *rates)


def _philox(idx, k0, k1, block, site):
    """Philox4x32-10's first word, with Python integers."""
    c = [idx & 0xFFFFFFFF, idx >> 32, block, site]
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & 0xFFFFFFFF,
             (p0 >> 32) ^ c[3] ^ k1, p0 & 0xFFFFFFFF]
        k0 = (k0 + 0x9E3779B9) & 0xFFFFFFFF
        k1 = (k1 + 0xBB67AE85) & 0xFFFFFFFF
    return c[0]


def test_draw_masks_gpt2_match_a_reference_philox():
    """Each element of the three masks is the Python-integer Philox draw of
    (seed words, layer, site 0 / 1 / 3, element index) against the 24-bit
    threshold: attention ((b * H + h) * T + tq) * T + tk, proj and MLP
    (b * T + t) * C + c."""
    rates = (0.3, 0.4)
    masks = _draw(layer_idx=5, rates=rates)
    thr, inv = FGT.rates_operands(*rates)
    B, T, C, H = ARGS.values()
    rng = np.random.default_rng(12)
    for m, site, kind in zip(masks, FGT.SITES, FGT._RATE_OF_SITE):
        flat = m.reshape(-1)
        for idx in rng.integers(0, flat.numel(), 64).tolist():
            keep = (_philox(idx, *SEEDS, 5, site) >> 8) < thr[kind]
            assert float(flat[idx]) == (np.float32(inv[kind]) if keep
                                        else 0.0), (site, idx)
    b, h, tq, tk = 3, 2, 4, 1
    assert float(masks[0][b, h, tq, tk]) == float(
        masks[0].reshape(-1)[((b * H + h) * T + tq) * T + tk])


def test_draw_masks_gpt2_are_a_pure_function_of_their_arguments():
    a, b = _draw(), _draw()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for other in (_draw(seeds=(1234, 568)), _draw(seeds=(1235, 567)),
                  _draw(layer_idx=2)):
        assert all(not torch.equal(x, y) for x, y in zip(a, other))
    # proj and MLP share a rate and a shape but are two streams
    assert not torch.equal(a[1], a[2])
    assert [tuple(m.shape) for m in a] == [(8, 4, 5, 5), (40, 48), (40, 48)]
    assert all(m.dtype == torch.float32 for m in a)
    # the GPT-2 sites are the fuser generator's sites 0, 1, 3
    fuser = FT.draw_masks_plain(8, 5, 48, 4, SEEDS, 1, 0.1, 0.2, 0.0)
    assert all(torch.equal(x, fuser[i]) for x, i in zip(a, (0, 1, 3)))
    # draw_masks_gpt2 on the CPU is the plain version; B = 2 is a prefix
    c = FGT.draw_masks_gpt2(*ARGS.values(), SEEDS, 1, 0.1, 0.2, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, c))
    small = _draw(B=2)
    assert torch.equal(small[0], a[0][:2])
    assert torch.equal(small[1], a[1][:10]) and torch.equal(small[2],
                                                             a[2][:10])


def test_draw_masks_gpt2_values_and_keep_fractions():
    """Each element is 0 or 1 / keep; the kept share lies within 4 binomial
    standard deviations of 1 - rate; rate 0 keeps everything at scale 1,
    rate 1 nothing."""
    rates = (0.1, 0.3)
    masks = _draw(B=256, rates=rates)
    for m, kind in zip(masks, FGT._RATE_OF_SITE):
        rate, n = rates[kind], m.numel()
        inv = np.float32(1.0 / (1.0 - rate))
        assert set(np.unique(m.numpy())) <= {np.float32(0), inv}
        kept = float((m > 0).float().mean())
        sigma = (rate * (1 - rate) / n) ** 0.5
        assert abs(kept - (1 - rate)) <= 4 * sigma, (kind, kept, n)
    for m in _draw(rates=(0.0, 0.0)):
        assert torch.equal(m, torch.ones_like(m))
    for m in _draw(rates=(1.0, 1.0)):
        assert torch.equal(m, torch.zeros_like(m))


def test_fused_gpt2_block_train_checks_its_operands():
    params = W.gpt2_block_from_jax(jax.tree.map(np.asarray, _jax_layer(32)),
                                   4)
    with pytest.raises(ValueError, match=r"\(B, T, C\)"):
        FGT.fused_gpt2_block_train(torch.zeros(4, 32), params, None, SEEDS,
                                   num_heads=4)
    with pytest.raises(ValueError, match="seeds"):
        FGT.fused_gpt2_block_train(torch.zeros(2, 3, 32), params, None,
                                   (1, 2 ** 31), num_heads=4)
    assert FGT.rates_operands(0.1, 1.0) == (
        [15099494, 0, 1 << 24], [1 / 0.9, 0.0, 1.0])
    with pytest.raises(ValueError, match="unsupported device"):
        FGT.draw_masks_gpt2(2, 3, 32, 4, SEEDS, 0, 0.1, 0.1, device="meta")


# -- the predictor's training path --------------------------------------------

def _predictor(**rates):
    model = BaseFuturePredictor(in_features=32, inter_dim=32, n_layer=2,
                                n_head=4, **rates)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model.train()


def test_predictor_trains_through_the_gpt2_training_op(monkeypatch):
    """In training mode every layer goes through ``fused_gpt2_block_train``
    with its position as the layer index, and each pass draws its own pair
    of seed words: the three passes of a 3-step rollout three pairs. With
    attention weights asked for, the layers stay on the plain path."""
    calls = []
    real = FGT.fused_gpt2_block_train

    def spy(x, params, mask, seeds, **kw):
        calls.append((tuple(seeds), kw["layer_idx"], x.shape[1]))
        return real(x, params, mask, seeds, **kw)
    monkeypatch.setattr(FGT, "fused_gpt2_block_train", spy)
    model = _predictor()
    x = torch.randn(3, 6, 32)
    out, _ = model(x, 3, rng=L.RngStream(4))
    assert out.shape == (3, 8, 32)
    assert [c[1:] for c in calls] == [(0, 6), (1, 6), (0, 7), (1, 7),
                                      (0, 8), (1, 8)]
    seeds = [c[0] for c in calls]
    assert seeds[0] == seeds[1] and len(set(seeds)) == 3
    calls.clear()
    model.output_attentions = True
    _, att = model(x, rng=L.RngStream(4))
    assert not calls and att["gpt2_att_0"].shape == (3, 2, 4, 6, 6)


def test_predictor_plain_impl_equals_the_kernel_path_on_cpu():
    """``impl="plain"`` (the plain version on ``draw_masks_gpt2``'s masks)
    and ``impl="kernel"`` (the wrapper, which on the CPU draws the same
    masks) give the same bits, forward and backward, with dropout on."""
    model = _predictor()
    x = torch.randn(3, 6, 32)
    outs, grads = [], []
    for impl in ("kernel", "plain"):
        model.zero_grad()
        out, _ = model(x, impl=impl, rng=L.RngStream(9))
        out.square().sum().backward()
        outs.append(out.detach())
        grads.append([p.grad.clone() for p in model.parameters()])
    assert torch.equal(outs[0], outs[1])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    with pytest.raises(ValueError, match="RngStream"):
        model(x)
    zero = _predictor(embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0)
    assert zero(x)[0].requires_grad                # rates 0: no stream needed
