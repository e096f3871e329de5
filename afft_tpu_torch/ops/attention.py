"""Multi-head attention over separate q, k, v: CUDA kernel and plain version.

Replaces ``afft_tpu/ops/pallas_attn.py:fused_attention`` and the dispatch of
``afft_tpu/ops/attention.py:multihead_attention``. One attention serves the
KV-cache rollout of the predictor (new tokens against a preallocated cache)
and the cross-attention of the CA-Fuser's module path.

``fused_attention`` launches the kernel (``csrc/attention.cu``, one launch)
on CUDA tensors and runs ``attention_plain`` on CPU tensors. The kernel
never forms the (B, H, Nq, Nk) weights, so a caller that asks for them
(``return_weights=True``) gets the plain version on any device; that
dispatch is part of the function, as in the JAX package, and is counted in
``PLAIN_WEIGHTS_CALLS``.

Cast chain (``pallas_attn.py:54-70``): scores and softmax in fp32 with the
scale applied after the dot; the probabilities are divided in fp32 and
rounded to the input dtype before the probability . v product, which
accumulates in fp32; the output has q's dtype.

Kernel limits: q (B, Nq, H, hd), k and v (B, Nk, H, hd) with Nq >= 1,
1 <= Nk <= 1024 and any hd, float32 or bfloat16, all three on one device in
one dtype. q, k and v may be strided views (a column slice of a packed qkv
projection, a (B, Tmax, H, hd) cache): the kernel takes their sequence,
token and head strides and only needs unit stride along hd; nothing is
copied. The mask is an additive (Nq, Nk) tensor or None; -inf entries are
skipped, and every row must keep one finite entry.
"""

from __future__ import annotations

import torch

from ._common import (DTYPE_CODES, check_shape, launch, mask_operand, ptr,
                      softmax_attention32)

LAUNCHES = {"fused_attention": 0}
PLAIN_WEIGHTS_CALLS = {"attention_weights": 0}

MAX_KEYS = 1024


def attention_plain(q, k, v, mask=None, *, return_weights=False):
    """The kernel's arithmetic in PyTorch ops, on any device.

    Returns (out (B, Nq, H, hd) in q.dtype, weights (B, H, Nq, Nk) in
    q.dtype or None)."""
    dt = q.dtype
    q32, k32, v32 = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    out, p = softmax_attention32(q32, k32, v32, mask, round_p_to=dt)
    return (out.permute(0, 2, 1, 3).to(dt),
            p.to(dt) if return_weights else None)


def _check(name, q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be (B, N, H, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Nq, H, hd = q.shape
    Nk = k.shape[1]
    check_shape(name, "k", k, (B, Nk, H, hd))
    check_shape(name, "v", v, (B, Nk, H, hd))
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported "
                        "(float32 or bfloat16)")
    for key, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name}: {key} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {key} is {t.dtype}, q is {q.dtype}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    return B, Nq, Nk, H, hd


def fused_attention(q, k, v, mask=None):
    """softmax(q k^T * hd^-0.5 + mask) v; returns (B, Nq, H, hd) in q.dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    name = "fused_attention"
    B, Nq, Nk, H, hd = _check(name, q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, mask)[0]
    if not (Nq >= 1 and 1 <= Nk <= MAX_KEYS):
        raise ValueError(f"{name}: Nq={Nq}, Nk={Nk}; the kernel takes "
                         f"Nq >= 1 and 1 <= Nk <= {MAX_KEYS}")
    for key, t in (("q", q), ("k", k), ("v", v)):
        if hd > 1 and t.stride(3) != 1:
            raise ValueError(f"{name}: {key} must have unit stride along "
                             f"hd, got strides {t.stride()}")
    mask32 = mask_operand(name, mask, Nq, q.device, Nk)
    out = torch.empty((B, Nq, H, hd), dtype=q.dtype, device=q.device)
    if B * H * hd == 0:
        return out
    strides = [t.stride(d) for t in (q, k, v) for d in (0, 1, 2)]
    launch(name, "afft_fused_attention", DTYPE_CODES[q.dtype], ptr(q),
           ptr(k), ptr(v), ptr(mask32), ptr(out), B, Nq, Nk, H, hd, *strides,
           device=q.device)
    LAUNCHES[name] += 1
    return out


def multihead_attention(q, k, v, mask=None, *, return_weights=False):
    """(out, weights or None): the kernel path, or the plain version when
    the caller asks for the weights, which the kernel never forms."""
    if return_weights:
        _check("multihead_attention", q, k, v)
        PLAIN_WEIGHTS_CALLS["attention_weights"] += 1
        return attention_plain(q, k, v, mask, return_weights=True)
    return fused_attention(q, k, v, mask), None
