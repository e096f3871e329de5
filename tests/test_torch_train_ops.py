"""The training block of the port against the JAX package, on the CPU.

``ops.fused_block_train`` on CPU tensors runs its plain version, whose
backward is the backward kernels' plain version (``block_train_bwd_plain``)
under torch.autograd. The references are the JAX package's own:
``pallas_block_train.fused_block_train`` in interpret mode (custom VJP
through the Pallas backward kernels), ``blocks.block_apply`` and
``pallas_block_train.block_reference_with_masks`` under ``jax.grad``. Inputs
come from numpy seeds; fp32 but in the bf16 cast-chain test. Parameters and
gradients cross over through ``weights.block_from_jax`` (Linear weights
transposed).

Tolerances (only the summation order differs between the two frameworks):
forward 2e-5; dx rtol 1e-4, atol 2e-5; parameter gradients rtol 1e-4, atol
1e-4 (sums over up to 80 rows of O(1) terms), the bounds of
tests/test_ops_train.py's comparison with the XLA block, which hold here too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afft_tpu.models import blocks as JB
from afft_tpu.ops import pallas_block_train as PBT
from afft_tpu_torch import weights as W
from afft_tpu_torch.ops import fused_block as FB
from afft_tpu_torch.ops import fused_block_train as FT
from afft_tpu_torch.ops import fused_gpt2_train as FGT
from afft_tpu_torch.ops import launch_counts, reset_launches

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
DX_TOL = dict(rtol=1e-4, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
SEEDS = (1234, 567)


def _jax_block(C, H, qkv_bias=False, affine=True, seed=0):
    """A JAX block with every tensor away from its init value (biases and
    LayerNorm affines are zeros and ones at init)."""
    params = JB.block_init(jax.random.key(seed), C, H, 4.0, qkv_bias, affine)
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32)), params)


def _inputs(R, N, C, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((R, N, C)).astype(np.float32),
            rng.standard_normal((R, N, C)).astype(np.float32))


def _torch_grads(fn, x_np, params_np, cot_np):
    """(out, dx, {name: grad}) of sum(fn(x, params) * cot) in the port."""
    x = torch.tensor(x_np, requires_grad=True)
    p = {k: v.clone().requires_grad_(True)
         for k, v in W.block_from_jax(params_np).items()}
    out = fn(x, p)
    out.backward(torch.tensor(cot_np))
    return out.detach().numpy(), x.grad.numpy(), \
        {k: v.grad for k, v in p.items()}


def _assert_grads(got, want_jax, where):
    want = W.block_from_jax(jax.tree.map(np.asarray, want_jax))
    assert set(got) == set(want), (sorted(got), sorted(want))
    for name in sorted(want):
        assert got[name] is not None, f"{where}: no gradient for {name}"
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   err_msg=f"{where}: {name}", **GRAD_TOL)


def test_zero_rates_match_pallas_vjp_and_xla_block():
    """Rates 0 at the shape of tests/test_ops_train.py: the output, dx and
    every parameter gradient against the Pallas custom VJP (interpret mode)
    and against ``block_apply(train=False)`` under jax.grad."""
    N, C, H, R = 3, 128, 1, 16
    params = _jax_block(C, H)
    x_np, cot_np = _inputs(R, N, C)
    x_tm = jnp.asarray(x_np.transpose(1, 0, 2))      # JAX kernel: (N, R, C)
    cot_tm = jnp.asarray(cot_np.transpose(1, 0, 2))

    def pallas(x, p):
        return PBT.fused_block_train(x, p, None, jnp.asarray(SEEDS, jnp.int32),
                                     num_heads=H, block_idx=2, eps=1e-6,
                                     block_r=8, interpret=True)

    def xla(x, p):
        return JB.block_apply(p, x, H, None, train=False, norm_eps=1e-6,
                              need_weights=False)[0]

    want_pallas = pallas(x_tm, params)
    gx_p, gp_p = jax.grad(lambda x, p: jnp.sum(pallas(x, p) * cot_tm),
                          argnums=(0, 1))(x_tm, params)
    want_xla = xla(jnp.asarray(x_np), params)
    gx_x, gp_x = jax.grad(
        lambda x, p: jnp.sum(xla(x, p) * jnp.asarray(cot_np)),
        argnums=(0, 1))(jnp.asarray(x_np), params)

    reset_launches()
    out, dx, grads = _torch_grads(
        lambda x, p: FT.fused_block_train(x, p, None, SEEDS, num_heads=H,
                                          block_idx=2),
        x_np, jax.tree.map(np.asarray, params), cot_np)
    assert sum(launch_counts().values()) == 0    # CPU: the plain version
    np.testing.assert_allclose(
        out, np.asarray(want_pallas).transpose(1, 0, 2), **FWD_TOL)
    np.testing.assert_allclose(out, np.asarray(want_xla), **FWD_TOL)
    np.testing.assert_allclose(dx, np.asarray(gx_p).transpose(1, 0, 2),
                               **DX_TOL)
    np.testing.assert_allclose(dx, np.asarray(gx_x), **DX_TOL)
    _assert_grads(grads, gp_p, "vs the Pallas VJP")
    _assert_grads(grads, gp_x, "vs block_apply")
    # and the training block with rates 0 is the serving block
    serving = FB.fused_block(torch.tensor(x_np), W.block_from_jax(
        jax.tree.map(np.asarray, params)), None, num_heads=H)
    np.testing.assert_allclose(out, serving.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("qkv_bias,affine,diag", [
    (False, True, False), (True, True, True), (False, False, False),
    (True, False, True)])
def test_zero_rates_match_xla_block_small_heads(qkv_bias, affine, diag):
    """N 5, C 64, 4 heads of 16 (a width the Pallas kernel does not take),
    with and without the qkv bias, the norm affines and the additive mask:
    against ``block_apply(train=False)``. An absent tensor gets no gradient
    slot."""
    N, C, H, R = 5, 64, 4, 8
    params = _jax_block(C, H, qkv_bias, affine, seed=3)
    x_np, cot_np = _inputs(R, N, C, seed=4)
    mask_np = np.where(np.eye(N, dtype=bool), -np.inf, 0.0).astype(np.float32)
    mask_j = jnp.asarray(mask_np) if diag else None
    mask_t = torch.tensor(mask_np) if diag else None

    def xla(x, p):
        return JB.block_apply(p, x, H, mask_j, train=False, norm_eps=1e-6,
                              need_weights=False)[0]
    want = xla(jnp.asarray(x_np), params)
    gx, gp = jax.grad(lambda x, p: jnp.sum(xla(x, p) * jnp.asarray(cot_np)),
                      argnums=(0, 1))(jnp.asarray(x_np), params)
    out, dx, grads = _torch_grads(
        lambda x, p: FT.fused_block_train(x, p, mask_t, SEEDS, num_heads=H),
        x_np, jax.tree.map(np.asarray, params), cot_np)
    np.testing.assert_allclose(out, np.asarray(want), **FWD_TOL)
    np.testing.assert_allclose(dx, np.asarray(gx), **DX_TOL)
    _assert_grads(grads, gp, "vs block_apply")
    assert ("attn.qkv.bias" in grads) == qkv_bias
    assert ("norm1.weight" in grads) == affine


def _keep_all_masks(R, N, C, H, rates):
    """What the Pallas interpreter's zero draws give: every element kept,
    scaled by 1 / keep."""
    _, inv = FT.rates_operands(*rates)
    inv = [np.float32(v) for v in inv]
    return tuple(torch.full(shape, float(inv[kind]))
                 for shape, kind in zip(FT._mask_shapes(R, N, C, H),
                                        FT._RATE_OF_SITE))


def test_nonzero_rates_keep_all_masks_match_pallas_vjp():
    """Under the interpreter the TPU generator draws zeros, so the Pallas
    kernel's masks keep everything scaled by 1 / keep. The port's plain
    version fed the same masks must give the same output and gradients:
    that holds the scale at all five sites."""
    N, C, H, R = 3, 128, 1, 16
    rates = (0.1, 0.2, 0.05)
    params = _jax_block(C, H, seed=5)
    x_np, cot_np = _inputs(R, N, C, seed=6)
    x_tm = jnp.asarray(x_np.transpose(1, 0, 2))
    cot_tm = jnp.asarray(cot_np.transpose(1, 0, 2))

    def pallas(x, p):
        return PBT.fused_block_train(
            x, p, None, jnp.asarray(SEEDS, jnp.int32), num_heads=H,
            block_idx=2, eps=1e-6, block_r=8, interpret=True,
            attn_rate=rates[0], drop_rate=rates[1], dp_rate=rates[2])
    want = pallas(x_tm, params)
    gx, gp = jax.grad(lambda x, p: jnp.sum(pallas(x, p) * cot_tm),
                      argnums=(0, 1))(x_tm, params)
    masks = _keep_all_masks(R, N, C, H, rates)
    out, dx, grads = _torch_grads(
        lambda x, p: FT.fused_block_train_plain(x, p, None, masks,
                                                num_heads=H),
        x_np, jax.tree.map(np.asarray, params), cot_np)
    np.testing.assert_allclose(out, np.asarray(want).transpose(1, 0, 2),
                               **FWD_TOL)
    np.testing.assert_allclose(dx, np.asarray(gx).transpose(1, 0, 2),
                               **DX_TOL)
    _assert_grads(grads, gp, "keep-all masks vs the Pallas VJP")
    # the scales matter: with rates 0 the output differs
    zero = FT.fused_block_train(torch.tensor(x_np), W.block_from_jax(
        jax.tree.map(np.asarray, params)), None, SEEDS, num_heads=H)
    assert not np.allclose(out, zero.numpy(), atol=1e-3)


def test_bf16_cast_chain_matches_pallas_vjp():
    """bf16 at rates 0 (N 5, C 128, H 1, R 16): ``fused_block_train_plain``
    (its backward ``block_train_bwd_plain``, the backward kernels' cast
    chain) against the Pallas custom VJP in interpret mode, which rounds
    qkv, the stashed pre1 and y, dh2, dpre1, dy, dproj and dqkv to bf16 and
    keeps dh1, dg, d(attention output) and dxn in fp32
    (pallas_block_train.py:203-330). The output, dx and every parameter
    gradient per tensor within 8e-3 of the tensor's max |value| (two bf16
    ulps): the two differ only in the order of fp32 sums, which moves a
    value across a rounding boundary now and then. Worst reading 3.6e-3
    (the output; the gradients up to 3.5e-3, ``mlp.mlp.0.weight``). Plain
    autograd through the same forward, which rounds where the forward's
    casts lie, strays further (7.2e-3)."""
    N, C, H, R = 5, 128, 1, 16
    bf16 = jnp.bfloat16
    params = jax.tree.map(lambda a: a.astype(bf16), _jax_block(C, H, seed=7))
    x_np, cot_np = _inputs(R, N, C, seed=8)
    x_tm = jnp.asarray(x_np.transpose(1, 0, 2)).astype(bf16)
    cot_tm = jnp.asarray(cot_np.transpose(1, 0, 2))

    def pallas(x, p):
        return PBT.fused_block_train(x, p, None, jnp.asarray(SEEDS, jnp.int32),
                                     num_heads=H, block_idx=2, eps=1e-6,
                                     block_r=16, interpret=True)

    def f32(a):
        return np.asarray(jnp.asarray(a).astype(jnp.float32))
    want = f32(pallas(x_tm, params)).transpose(1, 0, 2)
    gx, gp = jax.grad(
        lambda x, p: jnp.sum(pallas(x, p).astype(jnp.float32) * cot_tm),
        argnums=(0, 1))(x_tm, params)
    refs = {"out": want, "dx": f32(gx).transpose(1, 0, 2),
            **{k: v.numpy() for k, v in W.block_from_jax(
                jax.tree.map(f32, gp)).items()}}
    masks = FT.draw_masks_plain(R, N, C, H, SEEDS, 2, 0.0, 0.0, 0.0)

    def worst(fn):
        """The largest per-tensor distance of ``fn``'s output, dx and
        gradients from the Pallas VJP's, over max|ref|."""
        x = torch.tensor(f32(x_tm).transpose(1, 0, 2))
        x = x.to(torch.bfloat16).requires_grad_(True)
        p = {k: v.to(torch.bfloat16).requires_grad_(True)
             for k, v in W.block_from_jax(jax.tree.map(f32, params)).items()}
        out = fn(x, p)
        assert out.dtype == torch.bfloat16
        out.float().backward(torch.tensor(cot_np))
        got = {"out": out.detach(), "dx": x.grad,
               **{k: v.grad for k, v in p.items()}}
        assert set(got) == set(refs)
        return max((np.abs(got[k].float().numpy() - ref).max()
                    / np.abs(ref).max(), k) for k, ref in refs.items())
    kernels_chain = worst(lambda x, p: FT.fused_block_train_plain(
        x, p, None, masks, num_heads=H))
    assert kernels_chain[0] <= 8e-3, kernels_chain
    autograd = worst(lambda x, p: FT._block_train_fwd_plain(
        x, p, None, masks, H, 1e-6)[0])
    assert kernels_chain[0] < autograd[0], (kernels_chain, autograd)


def masks_to_jax_tile(masks, R, N, C, H):
    """The port's per-element masks -> the JAX kernel's single-tile layout
    (``draw_masks`` with block_r = R): attention (1, R, Wa) with column
    (tq * N + tk) * H + h, padded to a multiple of 128; proj and MLP
    (1, N * R, C) with tokens-major rows t * R + r; drop-path (1, R, 128),
    of which column 0 is read."""
    mattn, mproj, dp1, mmlp, dp2 = (m.numpy() for m in masks)
    wa = PBT._attn_bits_width(H, N)
    attn = np.zeros((1, R, wa), np.float32)
    attn[0, :, :N * N * H] = mattn.transpose(0, 2, 3, 1).reshape(R, N * N * H)

    def rows(m):
        return m.reshape(R, N, C).transpose(1, 0, 2).reshape(1, N * R, C)

    def dp(m):
        return np.repeat(m.reshape(1, R, 1), 128, axis=2)
    return tuple(jnp.asarray(a) for a in (attn, rows(mproj), dp(dp1),
                                          rows(mmlp), dp(dp2)))


@pytest.mark.parametrize("N,C,H,R,diag", [(3, 128, 1, 16, False),
                                          (5, 64, 4, 8, True)])
def test_random_explicit_masks_match_jax_reference(N, C, H, R, diag):
    """Random 0 / (1 / keep) masks from numpy, converted to the JAX kernel's
    per-tile layout, through ``block_reference_with_masks`` + jax.grad and
    through ``fused_block_train_plain`` + autograd."""
    rates = (0.3, 0.2, 0.4)
    rng = np.random.default_rng(7)
    _, inv = FT.rates_operands(*rates)
    masks = tuple(
        torch.tensor(np.where(rng.random(shape) < 1 - rates[kind],
                              np.float32(inv[kind]), np.float32(0)))
        for shape, kind in zip(FT._mask_shapes(R, N, C, H), FT._RATE_OF_SITE))
    assert all(0 < float((m == 0).float().mean()) < 1 for m in masks)
    params = _jax_block(C, H, qkv_bias=diag, seed=8)
    x_np, cot_np = _inputs(R, N, C, seed=9)
    mask_np = (np.where(np.eye(N, dtype=bool), -np.inf, 0.0) if diag
               else np.zeros((N, N))).astype(np.float32)
    jmasks = masks_to_jax_tile(masks, R, N, C, H)
    x_tm = jnp.asarray(x_np.transpose(1, 0, 2))
    cot_tm = jnp.asarray(cot_np.transpose(1, 0, 2))

    def ref(x, p):
        return PBT.block_reference_with_masks(x, p, jnp.asarray(mask_np),
                                              jmasks, num_heads=H, eps=1e-6)
    want = ref(x_tm, params)
    gx, gp = jax.grad(lambda x, p: jnp.sum(ref(x, p) * cot_tm),
                      argnums=(0, 1))(x_tm, params)
    out, dx, grads = _torch_grads(
        lambda x, p: FT.fused_block_train_plain(
            x, p, torch.tensor(mask_np) if diag else None, masks,
            num_heads=H),
        x_np, jax.tree.map(np.asarray, params), cot_np)
    np.testing.assert_allclose(out, np.asarray(want).transpose(1, 0, 2),
                               **FWD_TOL)
    np.testing.assert_allclose(dx, np.asarray(gx).transpose(1, 0, 2),
                               **DX_TOL)
    _assert_grads(grads, gp, "random masks vs block_reference_with_masks")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("N", [1, 5, 8])
def test_attention_with_dropout_matches_pallas_attention_fwd(N, masked):
    """The training attention (fp32 probabilities scaled by their keep
    multipliers before P . V; the kernel's plain version,
    ``attention_drop_plain``) against ``pallas_block_train._attention_fwd``
    on the same qkv and masks, at the token counts the kernel takes (1 to
    8), with and without the causal mask. The JAX kernel's keep bits are
    made from the port's mask: 0 where kept, 2^24 - 1 where dropped."""
    R, C, H = 6, 16, 2
    hd = C // H
    rng = np.random.default_rng(N + 10 * masked)
    qkv = rng.standard_normal((R * N, 3 * C)).astype(np.float32)
    mattn = FT.draw_masks_plain(R, N, C, H, SEEDS, 1, 0.3, 0.0, 0.0)[0]
    mask = np.triu(np.full((N, N), -np.inf, np.float32), 1) if masked \
        else np.zeros((N, N), np.float32)
    thr, inv = FT.rates_operands(0.3, 0.0, 0.0)
    wa = PBT._attn_bits_width(H, N)
    bits = np.zeros((R, wa), np.int32)
    # column (tq * N + tk) * H + h of the JAX kernel's bits
    bits[:, :N * N * H] = np.where(
        mattn.numpy().transpose(0, 2, 3, 1).reshape(R, N * N * H) > 0, 0,
        (1 << 24) - 1)
    tok = qkv.reshape(R, N, 3 * C)
    q, k, v = ([jnp.asarray(tok[:, t, i * C:(i + 1) * C]) for t in range(N)]
               for i in range(3))
    want = PBT._attention_fwd(q, k, v, jnp.asarray(mask), jnp.asarray(bits),
                              jnp.asarray(thr, jnp.int32),
                              jnp.asarray(inv, jnp.float32), n_tokens=N,
                              num_heads=H, head_dim=hd)
    want = np.stack([np.asarray(o) for o in want], axis=1).reshape(R * N, C)
    got = FT.attention_drop_plain(torch.tensor(qkv), torch.tensor(mask)
                                  if masked else None, mattn, N, H)
    assert 0 < float((mattn == 0).float().mean()) < 1
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


# -- the mask generator -------------------------------------------------------

ARGS = dict(R=64, N=5, C=48, num_heads=4)


def _draw(seeds=SEEDS, block_idx=1, rates=(0.1, 0.2, 0.3), **kw):
    return FT.draw_masks_plain(*{**ARGS, **kw}.values(), seeds, block_idx,
                               *rates)


def test_draw_masks_are_a_pure_function_of_their_arguments():
    a, b = _draw(), _draw()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for other in (_draw(seeds=(1234, 568)), _draw(seeds=(1235, 567)),
                  _draw(block_idx=2)):
        assert all(not torch.equal(x, y) for x, y in zip(a, other))
    # the five sites are five streams: proj and MLP share a rate and a shape
    assert not torch.equal(a[1], a[3]) and not torch.equal(a[2], a[4])
    shapes = [tuple(m.shape) for m in a]
    assert shapes == [(64, 4, 5, 5), (320, 48), (64,), (320, 48), (64,)]
    assert all(m.dtype == torch.float32 for m in a)
    # FT.draw_masks on the CPU is the plain version
    c = FT.draw_masks(*ARGS.values(), SEEDS, 1, 0.1, 0.2, 0.3, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, c))


def test_draw_masks_values_and_keep_fractions():
    """Each element is 0 or 1 / keep; the kept share lies within 4 binomial
    standard deviations of 1 - rate; rate 0 keeps everything at scale 1."""
    rates = (0.1, 0.2, 0.3)
    masks = _draw(R=256, rates=rates)
    for m, kind in zip(masks, FT._RATE_OF_SITE):
        rate, n = rates[kind], m.numel()
        inv = np.float32(1.0 / (1.0 - rate))
        assert set(np.unique(m.numpy())) <= {np.float32(0), inv}
        kept = float((m > 0).float().mean())
        sigma = (rate * (1 - rate) / n) ** 0.5
        assert abs(kept - (1 - rate)) <= 4 * sigma, (kind, kept, n)
    for m in _draw(rates=(0.0, 0.0, 0.0)):
        assert torch.equal(m, torch.ones_like(m))
    for m in _draw(rates=(1.0, 1.0, 1.0)):
        assert torch.equal(m, torch.zeros_like(m))


def test_draw_masks_do_not_depend_on_the_row_count():
    """Element r of R = 16 equals element r of R = 64: a mask is a function
    of the logical element index, not of a tile."""
    small, large = _draw(R=16), _draw(R=64)
    assert torch.equal(small[0], large[0][:16])
    assert torch.equal(small[1], large[1][:16 * 5])
    assert torch.equal(small[2], large[2][:16])
    assert torch.equal(small[3], large[3][:16 * 5])
    assert torch.equal(small[4], large[4][:16])


def test_philox_matches_a_reference_implementation():
    """The generator in torch integer ops against Philox4x32-10 written
    with Python integers, at indices on both sides of 2^32."""
    def philox(idx, k0, k1, block, site):
        c = [idx & 0xFFFFFFFF, idx >> 32, block, site]
        for _ in range(10):
            p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
            c = [(p1 >> 32) ^ c[1] ^ k0, p1 & 0xFFFFFFFF,
                 (p0 >> 32) ^ c[3] ^ k1, p0 & 0xFFFFFFFF]
            k0 = (k0 + 0x9E3779B9) & 0xFFFFFFFF
            k1 = (k1 + 0xBB67AE85) & 0xFFFFFFFF
        return c[0]
    idx = [0, 1, 2, 65535, 65536, 2 ** 31 - 1, 2 ** 32 - 1, 2 ** 32,
           2 ** 33 + 7, 2 ** 40 + 123]
    got = FT.philox_word0(torch.tensor(idx), 2 ** 31 - 2, 77, 5, 3).tolist()
    assert got == [philox(i, 2 ** 31 - 2, 77, 5, 3) for i in idx]
    with pytest.raises(ValueError, match="seeds"):
        FT.draw_masks_plain(4, 2, 8, 1, (-1, 3), 0, 0.1, 0.1, 0.1)


def test_dropped_drop_path_rows_pass_x_and_its_gradient_through():
    """A row whose two drop-path multipliers are both 0 gives out == x and
    dx == dout exactly."""
    R, N, C, H = 64, 5, 32, 4
    rates = dict(attn_rate=0.1, drop_rate=0.1, dp_rate=0.5)
    params = W.block_from_jax(jax.tree.map(np.asarray, _jax_block(C, H)))
    x_np, cot_np = _inputs(R, N, C, seed=11)
    masks = FT.draw_masks_plain(R, N, C, H, SEEDS, 3, *rates.values())
    dropped = (masks[2] == 0) & (masks[4] == 0)
    assert 4 <= int(dropped.sum()) <= R - 4
    x = torch.tensor(x_np, requires_grad=True)
    out = FT.fused_block_train(x, params, None, SEEDS, num_heads=H,
                               block_idx=3, **rates)
    out.backward(torch.tensor(cot_np))
    assert torch.equal(out[dropped], x[dropped])
    assert torch.equal(x.grad[dropped], torch.tensor(cot_np)[dropped])
    assert not torch.equal(out[~dropped], x[~dropped])


def test_fused_block_train_checks_its_operands():
    params = W.block_from_jax(jax.tree.map(np.asarray, _jax_block(32, 4)))
    with pytest.raises(ValueError, match=r"\(R, N, C\)"):
        FT.fused_block_train(torch.zeros(4, 32), params, None, SEEDS,
                             num_heads=4)
    with pytest.raises(ValueError, match="seeds"):
        FT.fused_block_train(torch.zeros(2, 3, 32), params, None,
                             (1, 2 ** 31), num_heads=4)
    assert FT.rates_operands(0.1, 0.0, 1.0) == (
        [15099494, 1 << 24, 0], [1 / 0.9, 1.0, 0.0])


def _layer_params(layer, C, hidden):
    """Zero tensors of one training layer in its wrapper's layout."""
    if layer == "fuser":
        shapes = {"norm1.weight": (C,), "norm1.bias": (C,),
                  "attn.qkv.weight": (3 * C, C), "attn.proj.weight": (C, C),
                  "attn.proj.bias": (C,), "norm2.weight": (C,),
                  "norm2.bias": (C,), "mlp.mlp.0.weight": (hidden, C),
                  "mlp.mlp.0.bias": (hidden,),
                  "mlp.mlp.2.weight": (C, hidden), "mlp.mlp.2.bias": (C,)}
    else:
        shapes = dict(zip(FGT.KEYS, (
            (C,), (C,), (C, 3 * C), (3 * C,), (C, C), (C,), (C,), (C,),
            (C, hidden), (hidden,), (hidden, C), (C,))))
    return {k: torch.zeros(v) for k, v in shapes.items()}


@pytest.mark.parametrize("layer", ["fuser", "gpt2"])
def test_training_wrappers_apply_the_gemm_operand_rules(layer):
    """What both training wrappers check before a CUDA launch, where every
    bf16 product runs on gemm_sm90 (the fuser's forward and the GPT-2
    layer's backward dX on its (N, K) route): one dtype, contiguous and
    16-byte aligned operands; any C and hidden (C 20 and hidden 124, off
    the 16-byte grid, are taken: the GEMM packs such operands)."""
    check = (FB.block_operands if layer == "fuser"
             else FGT.gpt2_operands)
    x = torch.zeros(2, 3, 32)
    tensors, hidden = check("t", x, _layer_params(layer, 32, 128), 4)
    assert hidden == 128 and len(tensors) == 12
    tensors, hidden = check("t", torch.zeros(2, 3, 20),
                            _layer_params(layer, 20, 80), 4)
    assert hidden == 80 and len(tensors) == 12
    tensors, hidden = check("t", x, _layer_params(layer, 32, 124), 4)
    assert hidden == 124 and len(tensors) == 12
    shifted = torch.zeros(2 * 3 * 32 + 1)[1:].view(2, 3, 32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        check("t", shifted, _layer_params(layer, 32, 128), 4)
    p = _layer_params(layer, 32, 128)
    key = "attn.proj.weight" if layer == "fuser" else "attn.c_proj.weight"
    p[key] = p[key].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        check("t", x, p, 4)
    p = _layer_params(layer, 32, 128)
    p[key] = p[key].bfloat16()
    with pytest.raises(TypeError, match="torch.bfloat16"):
        check("t", x, p, 4)
