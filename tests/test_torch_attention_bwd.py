"""The training attention backward of the port against the JAX package, on
the CPU.

``ops.fused_block_train.attention_drop_bwd_plain`` is the plain version of
``csrc/attention_bwd.cuh``, the attention backward of both training layers
(rows 9 and 15 of the kernel table): from the stashed qkv and dao =
d(attention output) it gives the forward's attention output O (dWproj's
operand) and the packed dqkv. The references are the JAX package's own:
``jax.vjp`` of ``pallas_block_train._attention_fwd`` (the fuser's attention,
fp32) and the Pallas kernel ``pallas_gpt2_train._attn_bwd_kernel`` in
interpret mode (the GPT-2 layer's rounding, bf16). Inputs come from numpy
seeds.

Tolerances. fp32: 2e-5 (``FWD_TOL`` of tests/test_torch_train_ops.py; only
the summation order differs). bf16: the same roundings at the same places
(dao, p * keep and ds rounded before their products), so an element may
differ by one rounding flip: every element within one bf16 ulp of the
output's largest magnitude (2^-7 of max|ref|), and at least 95% of them the
same bits.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from afft_tpu.ops import pallas_block_train as PBT
from afft_tpu.ops import pallas_gpt2_train as PGT
from afft_tpu_torch.ops import fused_block_train as FT
from afft_tpu_torch.ops import gemm as G

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
SEEDS = (1234, 567)


def _causal(N):
    return np.triu(np.full((N, N), -np.inf, np.float32), 1)


def _tokens(a, R, N):
    """(R * N, C) rows -> the JAX kernel's list of N (R, C) token slabs."""
    return [jnp.asarray(a.reshape(R, N, -1)[:, t]) for t in range(N)]


def _rows(slabs, R, N):
    """N (R, C) slabs -> (R * N, C) rows."""
    return np.stack([np.asarray(s) for s in slabs], axis=1).reshape(R * N, -1)


# (N, masked, H): the fuser's token counts with and without the causal mask,
# and the GPT-2 layer's (16, 32) with it
@pytest.mark.parametrize("N,masked,H", [
    (1, False, 2), (1, True, 2), (5, False, 2), (5, True, 2), (8, False, 2),
    (8, True, 2), (16, True, 2), (32, True, 1)])
def test_plain_matches_jax_vjp_of_the_attention(N, masked, H):
    """fp32: O and dqkv of ``attention_drop_bwd_plain`` against the forward
    and ``jax.vjp`` of ``pallas_block_train._attention_fwd`` on the same
    qkv, keep bits (made from the port's mask: 0 where kept, 2^24 - 1 where
    dropped, as ``test_attention_with_dropout_matches_pallas_attention_fwd``
    makes them) and cotangent."""
    R, C = 3, 16
    hd = C // H
    rng = np.random.default_rng(N + 100 * masked)
    qkv = rng.standard_normal((R * N, 3 * C)).astype(np.float32)
    dao = rng.standard_normal((R * N, C)).astype(np.float32)
    mattn = FT.draw_masks_plain(R, N, C, H, SEEDS, 1, 0.3, 0.0, 0.0)[0]
    mask = _causal(N) if masked else np.zeros((N, N), np.float32)
    thr, inv = FT.rates_operands(0.3, 0.0, 0.0)
    bits = np.zeros((R, PBT._attn_bits_width(H, N)), np.int32)
    # column (tq * N + tk) * H + h of the JAX kernel's bits
    bits[:, :N * N * H] = np.where(
        mattn.numpy().transpose(0, 2, 3, 1).reshape(R, N * N * H) > 0, 0,
        (1 << 24) - 1)

    def attention(q, k, v):
        return PBT._attention_fwd(
            q, k, v, jnp.asarray(mask), jnp.asarray(bits),
            jnp.asarray(thr, jnp.int32), jnp.asarray(inv, jnp.float32),
            n_tokens=N, num_heads=H, head_dim=hd)
    q, k, v = (_tokens(qkv[:, i * C:(i + 1) * C], R, N) for i in range(3))
    out, vjp = jax.vjp(attention, q, k, v)
    dq, dk, dv = vjp(_tokens(dao, R, N))
    want = np.concatenate([_rows(g, R, N) for g in (dq, dk, dv)], axis=1)

    got_o, got = FT.attention_drop_bwd_plain(
        torch.tensor(qkv), torch.tensor(mask) if masked else None, mattn,
        torch.tensor(dao), N, H)
    assert 0 < float((mattn == 0).float().mean()) < 1
    np.testing.assert_allclose(got_o.numpy(), _rows(out, R, N), **FWD_TOL)
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


def _pallas_attn_bwd(x, dy, qkv_hm, flat, mask, rates, H):
    """``pallas_gpt2_train._attn_bwd_kernel`` in interpret mode, called as
    ``_core_bwd`` calls it (one tile): (dqkv heads-major, dproj, attn_out),
    in the working dtype."""
    B, T, C = x.shape
    dt = x.dtype
    ln1g, ln1b, wqkv, _, wproj = flat[:5]
    xs = PGT._specs(B, T, C)
    f32 = jnp.float32
    outs = pl.pallas_call(
        functools.partial(PGT._attn_bwd_kernel, n_tokens=T, num_heads=H,
                          head_dim=C // H, eps=1e-5),
        out_shape=(jax.ShapeDtypeStruct((B, T, C), dt),
                   jax.ShapeDtypeStruct((B * T, 3 * C), dt),
                   jax.ShapeDtypeStruct((B * T, C), dt),
                   jax.ShapeDtypeStruct((B * T, C), dt),
                   jax.ShapeDtypeStruct((B * T, C), dt),
                   jax.ShapeDtypeStruct((1, C), f32),
                   jax.ShapeDtypeStruct((1, C), f32)),
        grid=(1,),
        in_specs=[xs, xs, PGT._row_spec(B, T, 3 * C),
                  PGT._const((1, C)), PGT._const((1, C)),
                  PGT._const((C, 3 * C)), PGT._const((C, C)),
                  PGT._const((T, T)), PGT._smem(), PGT._smem(),
                  PGT._smem()],
        out_specs=(xs, PGT._row_spec(B, T, 3 * C), PGT._row_spec(B, T, C),
                   PGT._row_spec(B, T, C), PGT._row_spec(B, T, C),
                   PGT._acc_spec((1, C)), PGT._acc_spec((1, C))),
        interpret=PGT._interpret_params(True),
    )(x, dy, qkv_hm, ln1g, ln1b, wqkv, wproj, jnp.asarray(mask),
      PGT._seeds_operand(jnp.asarray(SEEDS, jnp.int32), 1),
      *PGT._rates_operands(*rates, 0.0))
    return outs[1], outs[2], outs[3]


def _close_bf16(got, want, what):
    """One bf16 ulp of the largest magnitude, most elements the same."""
    diff = np.abs(got.float().numpy() - want)
    assert diff.max() <= 2.0 ** -7 * np.abs(want).max(), what
    assert (diff == 0).mean() >= 0.95, what


@pytest.mark.parametrize("B,T,C,H", [(4, 8, 128, 2), (2, 16, 64, 4)])
def test_round_form_matches_the_pallas_gpt2_kernel_in_bf16(B, T, C, H):
    """bf16, the GPT-2 layer's rounding (``round_to``): O and dqkv of
    ``attention_drop_bwd_plain`` against the attention output and dqkv the
    Pallas attention-backward kernel exports, on its own stashed qkv and
    its own dattn = dproj . Wproj^T (computed here as the kernel computes
    it). Under the interpreter the TPU generator draws zeros, so the
    kernel's keep multipliers are all 1 / keep: the port's masks are too
    (rate 0.1 at the attention and proj sites)."""
    rates = (0.1, 0.1)
    bf = jnp.bfloat16
    rng = np.random.default_rng(T + H)
    params = {
        "ln_1": {"g": 1 + 0.05 * rng.standard_normal(C),
                 "b": 0.05 * rng.standard_normal(C)},
        "c_attn": {"w": 0.05 * rng.standard_normal((C, 3 * C)),
                   "b": 0.05 * rng.standard_normal(3 * C)},
        "c_proj": {"w": 0.05 * rng.standard_normal((C, C)),
                   "b": 0.05 * rng.standard_normal(C)},
        "ln_2": {"g": np.ones(C), "b": np.zeros(C)},
        "c_fc": {"w": np.zeros((C, 4 * C)), "b": np.zeros(4 * C)},
        "mlp_c_proj": {"w": np.zeros((4 * C, C)), "b": np.zeros(C)}}
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    flat = PGT._flat_params(params, C, 4 * C, bf)
    x = jnp.asarray(rng.standard_normal((B, T, C)), bf)
    dy = jnp.asarray(rng.standard_normal((B, T, C)), bf)
    qkv_hm = jnp.asarray(rng.standard_normal((B * T, 3 * C)), bf)
    mask = _causal(T)
    dqkv_hm, dproj, attn_out = _pallas_attn_bwd(x, dy, qkv_hm, flat, mask,
                                                rates, H)
    dattn = jax.lax.dot_general(
        dproj, flat[4], dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32)

    def to_port(a):  # heads-major [h: (q, k, v)] -> [q | k | v]
        a = np.asarray(jnp.asarray(a, jnp.float32))
        return a.reshape(B * T, H, 3, C // H).transpose(0, 2, 1, 3).reshape(
            B * T, 3 * C)
    _, inv = FT.rates_operands(rates[0], 0.0, 0.0)
    mattn = torch.full((B, H, T, T), float(np.float32(inv[0])))
    got_o, got = FT.attention_drop_bwd_plain(
        torch.tensor(to_port(qkv_hm)).to(torch.bfloat16), torch.tensor(mask),
        mattn, torch.tensor(np.asarray(dattn)), T, H,
        round_to=torch.bfloat16)
    _close_bf16(got_o.to(torch.bfloat16),
                np.asarray(jnp.asarray(attn_out, jnp.float32)), "O")
    _close_bf16(got.to(torch.bfloat16), to_port(dqkv_hm), "dqkv")


@pytest.mark.parametrize("gpt2", [False, True])
def test_plain_is_the_gradient_of_the_plain_forward(gpt2):
    """fp32: dqkv of ``attention_drop_bwd_plain`` is autograd's gradient of
    sum(attention_drop_plain(qkv) * dao), and its O is that forward, for
    either layer's token count (5 with the fuser's diagonal-free mask, 16
    causal)."""
    N, mask = (16, torch.tensor(_causal(16))) if gpt2 else (5, None)
    R, C, H = 4, 24, 2
    rng = np.random.default_rng(7 + gpt2)
    qkv = torch.tensor(rng.standard_normal((R * N, 3 * C)), dtype=torch.float32,
                       requires_grad=True)
    dao = torch.tensor(rng.standard_normal((R * N, C)), dtype=torch.float32)
    mattn = FT.draw_masks_plain(R, N, C, H, SEEDS, 2, 0.5, 0.0, 0.0)[0]
    out = FT.attention_drop_plain(qkv, mask, mattn, N, H)
    out.backward(dao)
    got_o, got = FT.attention_drop_bwd_plain(qkv.detach(), mask, mattn, dao,
                                             N, H)
    np.testing.assert_allclose(got_o.numpy(), out.detach().numpy(),
                               rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), qkv.grad.numpy(), **FWD_TOL)


@pytest.mark.parametrize("gpt2", [False, True])
def test_cpu_wrappers_take_the_plain_versions_on_drawn_masks(gpt2):
    """On CPU tensors ``attention_drop`` and ``attention_drop_bwd`` are the
    plain versions on the attention mask of ``draw_masks_plain`` at their
    seeds, block index and rate, in qkv.dtype (bf16 here: the GPT-2 layer's
    p * keep rounded, the fuser's not); the forward's output is the
    backward's O."""
    N, mask = (16, torch.tensor(_causal(16))) if gpt2 else (5, None)
    R, C, H, dt = 3, 48, 4, torch.bfloat16
    rng = np.random.default_rng(11)
    qkv = torch.tensor(rng.standard_normal((R * N, 3 * C))).to(dt)
    dao = torch.tensor(rng.standard_normal((R * N, C)), dtype=torch.float32)
    kw = dict(n_tokens=N, num_heads=H, block_idx=3, attn_rate=0.2, gpt2=gpt2)
    fwd = FT.attention_drop(qkv, mask, SEEDS, **kw)
    out, dqkv = FT.attention_drop_bwd(qkv, mask, dao, SEEDS, **kw)
    mattn = FT.draw_masks_plain(R, N, C, H, SEEDS, 3, 0.2, 0.0, 0.0)[0]
    round_to = dt if gpt2 else None
    want_o, want = FT.attention_drop_bwd_plain(qkv, mask, mattn, dao, N, H,
                                               round_to)
    assert fwd.dtype == out.dtype == dqkv.dtype == dt
    assert torch.equal(fwd, out) and torch.equal(out, want_o.to(dt))
    assert torch.equal(dqkv, want.to(dt))
    assert torch.equal(fwd, FT.attention_drop_plain(
        qkv, mask, mattn, N, H, round_to).to(dt))


@pytest.mark.parametrize("case", ["fuser_n9", "gpt2_n33", "dao_bf16",
                                  "dao_shape", "heads"])
def test_wrappers_refuse_what_the_kernels_do_not_take(case):
    """The shape rules, applied on every device: an fp32 dao of the
    attention output's shape, H * hd == C. Any length is taken: past 8
    tokens for the fuser's arithmetic and 32 for the GPT-2 layer's the
    kernels take the long route, and on the CPU the wrappers return their
    plain versions' results (``fuser_n9``, ``gpt2_n33``)."""
    N, H, gpt2, C = {"fuser_n9": (9, 2, False, 16),
                     "gpt2_n33": (33, 2, True, 16)}.get(case, (4, 2, True, 16))
    if case == "heads":
        H = 3
    if case in ("fuser_n9", "gpt2_n33"):
        rng = np.random.default_rng(N)
        qkv = torch.tensor(rng.standard_normal((2 * N, 3 * C)),
                           dtype=torch.float32)
        dao = torch.tensor(rng.standard_normal((2 * N, C)),
                           dtype=torch.float32)
        mask = torch.full((N, N), float("-inf")).triu(1) if gpt2 else None
        mattn = FT.draw_masks_plain(2, N, C, H, SEEDS, 0, 0.0, 0.0, 0.0)[0]
        fwd = FT.attention_drop(qkv, mask, SEEDS, n_tokens=N, num_heads=H,
                                gpt2=gpt2)
        out, dqkv = FT.attention_drop_bwd(qkv, mask, dao, SEEDS, n_tokens=N,
                                          num_heads=H, gpt2=gpt2)
        round_to = torch.float32 if gpt2 else None
        want_o, want = FT.attention_drop_bwd_plain(qkv, mask, mattn, dao, N,
                                                   H, round_to)
        assert fwd.shape == out.shape == (2 * N, C)
        assert torch.equal(fwd, FT.attention_drop_plain(qkv, mask, mattn, N,
                                                        H, round_to))
        assert torch.equal(out, want_o) and torch.equal(dqkv, want)
        return
    qkv = torch.zeros(2 * N, 3 * C)
    dao = torch.zeros(2 * N, C)
    if case == "dao_bf16":
        dao = dao.to(torch.bfloat16)
    if case == "dao_shape":
        dao = torch.zeros(2 * N, C + 8)
    with pytest.raises(ValueError):
        FT.attention_drop_bwd(qkv, None, dao, SEEDS, n_tokens=N, num_heads=H,
                              gpt2=gpt2)
    if case == "heads":
        with pytest.raises(ValueError):
            FT.attention_drop(qkv, None, SEEDS, n_tokens=N, num_heads=H,
                              gpt2=gpt2)


def test_gemm_tn_slices_leave_the_plain_result_and_refuse_zero():
    """``gemm_tn``'s slices over M change nothing on the CPU (the plain
    version is the exact sum) and must be at least 1."""
    rng = np.random.default_rng(3)
    a = torch.tensor(rng.standard_normal((96, 16))).to(torch.bfloat16)
    b = torch.tensor(rng.standard_normal((96, 24))).to(torch.bfloat16)
    assert torch.equal(G.gemm_tn(a, b, slices=4), G.gemm_tn(a, b))
    with pytest.raises(ValueError):
        G.gemm_tn(a, b, slices=0)
