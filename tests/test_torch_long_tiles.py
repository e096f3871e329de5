"""The rounding chain of the tensor-core long attention route on the CPU.

``csrc/long_attention.cu`` runs the long route's bf16 forms (rows 2, 4, 5,
6, 11 and 15 past their short lengths) on ``mma.sync``: bf16 operands,
fp32 scores a chunk of 64 keys at a time, a two-pass softmax (pass 1 each
query's max m and sum l over the chunks, online; pass 2 p = exp(s - m) / l,
times its keep multiplier, rounded to bf16 before P . V), and a backward
that rebuilds P from the stash (m, l) and reads dao rounded to bf16 (D =
rowsum(dao . O), dS = p (dP keep - D) rounded). A masked pair contributes
exactly 0, and a key row no query sees is staged as zeros. ``emulate_forward``
and ``emulate_backward`` below are that arithmetic in plain torch, chunk by
chunk (the sums inside a chunk in torch's order, not the tensor cores').

They are held, at the tolerances the card's check holds the kernels to
(chip_smoke.py: 1e-2 of max|ref| forward, 2e-2 gradients), against the JAX
package's attention (``afft_tpu.ops.attention.attention_reference``, its
``jax.vjp`` for the gradients) at attention dropout 0, and against the
port's plain versions (``attention_drop_plain`` / ``attention_drop_bwd_plain``
on the masks of ``draw_masks_plain``; ``attention_plain`` for the sequence
attention) with dropout: GPT-2 contexts of 33 and 1,024 tokens (causal, hd
512), 16 queries over 1,025 cache slots whose unwritten slots hold NaN, and
hd 12. The inputs are made from numpy seeds here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afft_tpu.ops import attention as JA
from afft_tpu_torch.ops import attention as FA
from afft_tpu_torch.ops import fused_block_train as FT

KC = 64                 # keys a chunk (csrc/long_attention.cu LM_KC)
FWD_TOL = 1e-2          # chip_smoke.py KERNEL_TOL["bf16"]
GRAD_TOL = 2e-2         # chip_smoke.py GRAD_TOL["bf16"]
SEEDS = [1234, 5678]
RATE = 0.1
BLOCK = 4


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _scores(q, k, mask, scale):
    """One chunk's scores: fp32 dots of bf16 operands, scaled, masked; -inf
    where the mask is."""
    s = (q @ k.transpose(-1, -2)) * scale
    if mask is None:
        return s
    return torch.where(torch.isinf(mask), torch.full_like(s, -np.inf),
                       s + mask)


def _chunks(nk):
    return [(k0, min(k0 + KC, nk)) for k0 in range(0, nk, KC)]


def _seen_rows(mask, nk):
    """The key rows some query sees (the kernel stages the others as zeros)."""
    if mask is None:
        return torch.ones(nk, dtype=torch.bool)
    return torch.isfinite(mask).any(dim=0)


def emulate_forward(q, k, v, mask=None, keep=None):
    """The forward's arithmetic on (B, H, N, hd) bf16-valued fp32 operands,
    keep (B, H, Nq, Nk) or None: returns (O fp32 (B, H, Nq, hd), m, l)."""
    scale = q.shape[-1] ** -0.5
    seen = _seen_rows(mask, k.shape[2])[:, None]
    # rows no query sees: zeros, never NaN
    k, v = (torch.where(seen, t, torch.zeros_like(t)) for t in (k, v))
    shape = q.shape[:-1] + (1,)
    m = torch.full(shape, -np.inf)
    l = torch.zeros(shape)
    for k0, k1 in _chunks(k.shape[2]):   # pass 1: online max and sum
        s = _scores(q, k[:, :, k0:k1], None if mask is None
                    else mask[:, k0:k1], scale)
        mn = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        live = torch.isfinite(mn)
        e = torch.where(torch.isfinite(s), torch.exp(s - mn),
                        torch.zeros_like(s)).sum(dim=-1, keepdim=True)
        old = torch.where(torch.isfinite(m), l * torch.exp(m - mn),
                          torch.zeros_like(l))
        l = torch.where(live, old + e, l)
        m = torch.where(live, mn, m)
    o = torch.zeros_like(q)
    for k0, k1 in _chunks(k.shape[2]):   # pass 2: P rounded, then P . V
        s = _scores(q, k[:, :, k0:k1], None if mask is None
                    else mask[:, k0:k1], scale)
        p = torch.where(torch.isfinite(s), torch.exp(s - m) / l,
                        torch.zeros_like(s))
        if keep is not None:
            p = p * keep[..., k0:k1]
        o = o + _bf16(p) @ v[:, :, k0:k1]
    return o, m, l


def emulate_backward(q, k, v, mask, keep, dao):
    """The backward's arithmetic: O from the forward, D = rowsum(dao . O)
    with dao rounded, then chunk by chunk dP = dao . v^T * keep, dS = p (dP
    - D) rounded, dV += (p keep)^T . dao, dK += dS^T . q, dQ += dS . k.
    Returns (O, dq, dk, dv), fp32 (B, H, N, hd)."""
    scale = q.shape[-1] ** -0.5
    o, m, l = emulate_forward(q, k, v, mask, keep)
    seen = _seen_rows(mask, k.shape[2])[:, None]
    k, v = (torch.where(seen, t, torch.zeros_like(t)) for t in (k, v))
    g = _bf16(dao)
    d = (g * o).sum(dim=-1, keepdim=True)
    dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
    for k0, k1 in _chunks(k.shape[2]):
        s = _scores(q, k[:, :, k0:k1], None if mask is None
                    else mask[:, k0:k1], scale)
        vis = torch.isfinite(s)
        p = torch.where(vis, torch.exp(s - m) / l, torch.zeros_like(s))
        kp = keep[..., k0:k1] if keep is not None else torch.ones_like(p)
        dp = (g @ v[:, :, k0:k1].transpose(-1, -2)) * kp
        ds = _bf16(torch.where(vis, p * (dp - d), torch.zeros_like(p)))
        dv[:, :, k0:k1] = dv[:, :, k0:k1] + \
            _bf16(p * kp).transpose(-1, -2) @ g
        dk[:, :, k0:k1] = dk[:, :, k0:k1] + ds.transpose(-1, -2) @ q
        dq = dq + ds @ k[:, :, k0:k1]
    return o, dq * scale, dk * scale, dv


def _rel(got, want):
    got, want = (np.asarray(t.float().numpy() if isinstance(t, torch.Tensor)
                            else t, np.float64) for t in (got, want))
    assert np.isfinite(got).all()
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _causal(n):
    return torch.full((n, n), -np.inf).triu(1)


def _cache_mask(nq, nk, junk):
    """The rollout's cache mask: query i (at position nk - nq - junk + i)
    sees the slots up to its position; the last ``junk`` slots are
    unwritten."""
    pos = nk - nq - junk
    key = torch.arange(nk)[None, :]
    query = pos + torch.arange(nq)[:, None]
    return torch.zeros(nq, nk).masked_fill(key > query, -np.inf)


# name: (B, H, N, hd) of a packed self-attention (the GPT-2 layer, causal)
SELF_CASES = {"t33_hd512": (2, 2, 33, 512), "t1024_hd512": (1, 1, 1024, 512),
              "t40_hd12": (2, 2, 40, 12)}


def _self_operands(name):
    B, H, N, hd = SELF_CASES[name]
    rng = np.random.default_rng(N * 7 + hd)
    C = H * hd
    qkv = torch.from_numpy(rng.standard_normal((B * N, 3 * C),
                                               dtype=np.float32))
    qkv = _bf16(qkv)
    dao = torch.from_numpy(rng.standard_normal((B * N, C), dtype=np.float32))
    heads = [t.reshape(B, N, H, hd).permute(0, 2, 1, 3)
             for t in qkv.chunk(3, dim=1)]
    return B, H, N, hd, qkv, dao, heads


def _rows(t):
    B, H, N, hd = t.shape
    return t.permute(0, 2, 1, 3).reshape(B * N, H * hd)


def _keep(B, N, C, H):
    return FT.draw_masks_plain(B, N, C, H, SEEDS, BLOCK, RATE, 0.0, 0.0)[0]


@pytest.mark.parametrize("name", sorted(SELF_CASES))
def test_forward_matches_jax(name):
    """Attention dropout 0: the emulated forward against the JAX package's
    attention on the same bf16 values (fp32 arithmetic)."""
    B, H, N, hd, qkv, dao, (q, k, v) = _self_operands(name)
    mask = _causal(N)
    got, _, _ = emulate_forward(q, k, v, mask)
    want = JA.attention_reference(
        *(jnp.asarray(t.permute(0, 2, 1, 3).numpy()) for t in (q, k, v)),
        jnp.asarray(mask.numpy()))[0]
    assert _rel(_bf16(got.permute(0, 2, 1, 3)), want) <= FWD_TOL


@pytest.mark.parametrize("name", sorted(SELF_CASES))
def test_forward_with_dropout_matches_plain(name):
    """Rate 0.1: the emulated forward against ``attention_drop_plain`` (the
    GPT-2 chain, p * keep rounded) on the masks of ``draw_masks_plain``."""
    B, H, N, hd, qkv, dao, (q, k, v) = _self_operands(name)
    mask, keep = _causal(N), _keep(B, N, H * hd, H)
    got, _, _ = emulate_forward(q, k, v, mask, keep)
    want = FT.attention_drop_plain(qkv, mask, keep, N, H, torch.bfloat16)
    assert _rel(_bf16(_rows(got)), want) <= FWD_TOL


@pytest.mark.parametrize("name", sorted(SELF_CASES))
def test_backward_matches_jax_vjp(name):
    """Attention dropout 0: the emulated gradients against ``jax.vjp`` of
    the JAX package's attention, the cotangent dao rounded to bf16 (as the
    bf16 layer reads it)."""
    B, H, N, hd, qkv, dao, (q, k, v) = _self_operands(name)
    mask = _causal(N)
    g = dao.reshape(B, N, H, hd).permute(0, 2, 1, 3)
    _, dq, dk, dv = emulate_backward(q, k, v, mask, None, g)
    jm = jnp.asarray(mask.numpy())
    _, vjp = jax.vjp(lambda a, b, c: JA.attention_reference(a, b, c, jm)[0],
                     *(jnp.asarray(t.permute(0, 2, 1, 3).numpy())
                       for t in (q, k, v)))
    want = vjp(jnp.asarray(_bf16(g).permute(0, 2, 1, 3).numpy()))
    for got, ref in zip((dq, dk, dv), want):
        assert _rel(_bf16(got.permute(0, 2, 1, 3)), ref) <= GRAD_TOL


@pytest.mark.parametrize("name", sorted(SELF_CASES))
def test_backward_with_dropout_matches_plain(name):
    """Rate 0.1: the emulated O and dqkv against ``attention_drop_bwd_plain``
    (the GPT-2 layer's chain) on the same keep masks."""
    B, H, N, hd, qkv, dao, (q, k, v) = _self_operands(name)
    mask, keep = _causal(N), _keep(B, N, H * hd, H)
    g = dao.reshape(B, N, H, hd).permute(0, 2, 1, 3)
    o, dq, dk, dv = emulate_backward(q, k, v, mask, keep, g)
    want_o, want_dqkv = FT.attention_drop_bwd_plain(qkv, mask, keep, dao, N,
                                                    H, torch.bfloat16)
    assert _rel(_bf16(_rows(o)), want_o) <= FWD_TOL
    got = torch.cat([_rows(t) for t in (dq, dk, dv)], dim=1)
    for part in range(3):
        C = H * hd
        assert _rel(_bf16(got[:, part * C:(part + 1) * C]),
                    want_dqkv[:, part * C:(part + 1) * C]) <= GRAD_TOL


@pytest.mark.parametrize("ref", ["jax", "plain"])
def test_cache_slots_past_1024_keys(ref):
    """Row 4's long route: 16 queries over 1,025 cache slots, hd 512, the
    rollout's cache mask, NaN in the 7 unwritten slots: finite, and within
    tolerance of the JAX package's attention and of ``attention_plain`` on
    the written slots."""
    rng = np.random.default_rng(1025)
    B, H, nq, nk, hd, junk = 2, 2, 16, 1025, 512, 7
    q, k, v = (_bf16(torch.from_numpy(rng.standard_normal(
        (B, n, H, hd), dtype=np.float32))) for n in (nq, nk, nk))
    mask = _cache_mask(nq, nk, junk)
    kn, vn = k.clone(), v.clone()
    kn[:, nk - junk:] = np.nan
    vn[:, nk - junk:] = np.nan
    got, _, _ = emulate_forward(*(t.permute(0, 2, 1, 3) for t in (q, kn, vn)),
                                mask)
    got = _bf16(got.permute(0, 2, 1, 3))
    if ref == "jax":
        want = JA.attention_reference(*(jnp.asarray(t.numpy())
                                        for t in (q, k, v)),
                                      jnp.asarray(mask.numpy()))[0]
    else:
        want = FA.attention_plain(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                  mask)[0]
    assert _rel(got, want) <= FWD_TOL


def test_masked_pairs_give_zeros():
    """A query whose keys are all masked gives zeros, and its gradients
    are zeros; a masked pair's NaN key never reaches a result."""
    rng = np.random.default_rng(3)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(
        (1, 1, 70, 16), dtype=np.float32)) for _ in range(4))
    mask = _causal(70)
    mask[5] = -np.inf            # query 5 sees nothing
    o, dq, dk, dv = emulate_backward(q, k, v, mask, None, g)
    assert torch.equal(o[0, 0, 5], torch.zeros(16))
    assert torch.equal(dq[0, 0, 5], torch.zeros(16))
    assert all(bool(torch.isfinite(t).all()) for t in (o, dq, dk, dv))
