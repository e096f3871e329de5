"""Operand checks and plain building blocks shared by the kernel wrappers."""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def ptr(t):
    return None if t is None else t.data_ptr()


def ptr_array(tensors):
    """A host array of device pointers (null for None), for the entry
    points that take their parameters as one array."""
    return (ctypes.c_void_p * len(tensors))(*[ptr(t) for t in tensors])


def check_operands(name: str, x: torch.Tensor, operands: dict) -> None:
    """CUDA operands must share x's device and dtype, be contiguous and
    16-byte aligned (the GEMMs copy 16-byte chunks)."""
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        "(float32 or bfloat16)")
    for key, t in [("x", x), *operands.items()]:
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name}: {key} on {t.device}, x on {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: {key} is {t.dtype}, x is {x.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")


def check_shape(name: str, key: str, t, shape) -> None:
    if t is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def mask_operand(name: str, mask, n: int, device, n_keys=None):
    """The additive (n, n_keys or n) mask as contiguous fp32 on the
    device."""
    if mask is None:
        return None
    check_shape(name, "mask", mask, (n, n if n_keys is None else n_keys))
    return mask.to(device=device, dtype=torch.float32).contiguous()


def launch(name: str, entry: str, *args, device) -> None:
    """Call the C entry point ``entry`` with ``args`` on ``device`` and its
    current stream (the stream is the last argument); raise if it reports
    a launch error."""
    with torch.cuda.device(device):
        err = getattr(_build.library(), entry)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")


# -- plain versions of the pieces (fp32 arithmetic on the working dtype) ----

def layer_norm32(x32, weight, bias, eps):
    """LayerNorm in fp32 (the kernels' statistics), affine optional."""
    return F.layer_norm(
        x32, x32.shape[-1:],
        None if weight is None else weight.float(),
        None if bias is None else bias.float(), eps)


def matmul32(a, w, w_in_out: bool):
    """a @ W with fp32 accumulation of the working dtype's exact products:
    W is (out, in) for an nn.Linear weight, (in, out) for a Conv1D."""
    w32 = w.float()
    return a.float() @ (w32 if w_in_out else w32.t())


def add_bias(acc32, bias):
    return acc32 if bias is None else acc32 + bias.float()


def softmax_attention32(q, k, v, mask, round_p_to=None):
    """softmax(q k^T * hd^-0.5 + mask) v on fp32 (..., Nq | Nk, hd)
    operands: scores with max subtraction and the division in fp32; the
    probabilities are rounded to ``round_p_to`` before P . V if given.
    Returns (out, probabilities), both fp32."""
    s = (q @ k.transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    if mask is not None:
        s = s + mask.float()
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    p = e / e.sum(dim=-1, keepdim=True)
    if round_p_to is not None:
        p = p.to(round_p_to).float()
    return p @ v, p


def attention32(qkv, mask, seq: int, num_heads: int, round_p_to=None):
    """Softmax attention over ``seq`` tokens of (n * seq, 3C) qkv rows
    ([q | k | v], heads minor), as ``softmax_attention32``.
    Returns (n * seq, C) fp32."""
    rows, three_c = qkv.shape
    C = three_c // 3
    hd = C // num_heads
    q, k, v = (qkv.float().reshape(rows // seq, seq, 3, num_heads, hd)
               .permute(2, 0, 3, 1, 4))                  # 3 x (n, H, S, hd)
    out, _ = softmax_attention32(q, k, v, mask, round_p_to)
    return out.permute(0, 2, 1, 3).reshape(rows, C)
