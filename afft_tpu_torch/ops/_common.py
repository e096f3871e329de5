"""Operand checks and plain building blocks shared by the kernel wrappers."""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

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


def check_no_grad(name: str, tensors) -> None:
    """The serving kernels have no backward: raise where autograd would
    record a gradient through one."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: this kernel has no backward and an operand requires a "
            "gradient; call it under torch.no_grad(), or train through "
            "ops.fused_block_train and the model's training mode")


def check_operands(name: str, x: torch.Tensor, operands: dict,
                   differentiable: bool = False) -> None:
    """CUDA operands must share x's device and dtype, be contiguous and
    16-byte aligned (the GEMMs copy 16-byte chunks); unless the kernel is
    ``differentiable``, none may require a gradient."""
    if not differentiable:
        check_no_grad(name, [x, *operands.values()])
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


def check_heads(name: str, C: int, num_heads: int) -> int:
    """The kernels' shape rule: H * hd == C with any head width hd >= 1 (the
    attentions read scalars, or 16-byte chunks where rows allow; the Hopper
    GEMM takes any K and N, packing an operand whose rows are off TMA's
    16-byte grid, ``pack_scratch``). Returns hd."""
    hd = C // num_heads if num_heads > 0 else 0
    if hd < 1 or hd * num_heads != C:
        raise ValueError(f"{name}: needs H*hd == C with hd >= 1 (C={C}, "
                         f"H={num_heads})")
    return hd


def pad8(n: int) -> int:
    """n rounded up to a multiple of 8."""
    return -(-n // 8) * 8


def pack_scratch(like, M: int, *widths: int):
    """The pack arena of one entry's launch over M rows on like's device
    (``launch``), or None where it needs none: in fp32 (the products run on
    gemm_f32) and where each of ``widths``, every dimension of the entry's
    weights, is a multiple of 8 (every operand then lies on TMA's 16-byte
    grid). The Hopper GEMM (``csrc/gemm_sm90.cuh`` ``tma_operand``) packs an
    operand whose rows are off that grid into rows of ``pad8`` columns, and
    a product packs at most two operands, each of at most w columns, w the
    largest width: an M-row input and a weight (forward, dX), or two M-row
    operands (a weight gradient). So 2 M pad8(w) + w pad8(w) elements hold
    any product of the entry."""
    if like.dtype != torch.bfloat16 or not any(w % 8 for w in widths):
        return None
    w = max(widths)
    return torch.empty((2 * M + w) * pad8(w), dtype=torch.bfloat16,
                       device=like.device)


# The longest sequence each short attention kernel takes: the fuser blocks'
# rows kernel (csrc/fuser_attention.cuh FR_MAX_N, rows 1, 7, 9), the GPT-2
# entries' staged attention (staged_attention.cuh AS_MAX_N, rows 2, 11, 15)
# and the sequence attention over keys (fuser_attention.cuh FS_MAX_KEYS,
# rows 4-6). Past it an entry takes the long route (long_attention.cuh).
SHORT_LENGTH = {"fuser": 8, "gpt2": 32, "keys": 1024}
LONG_MAX_QUERIES = 65535 * 16  # 16-query tiles (LA_TILE) in a grid's y

# The launches whose attention took the long route, by wrapper (each is in
# its wrapper's own count too).
LONG_LAUNCHES = dict.fromkeys((
    "fused_block", "gpt2_attn_half", "fused_attention", "fused_seq_block",
    "fused_decoder_block", "fused_block_train_fwd",
    "fused_block_train_bwd_attn", "fused_gpt2_train_fwd",
    "fused_gpt2_train_bwd_attn", "attention_drop", "attention_drop_bwd"), 0)


def long_route(kind: str, n: int) -> bool:
    """Whether an attention of ``kind`` over n tokens (keys for "keys")
    takes the long route."""
    return n > SHORT_LENGTH[kind]


def check_length(name: str, kind: str, n: int, hd: int,
                 n_queries=None) -> bool:
    """The kernels' length rule, beside ``check_heads``: any length n >= 1
    of tokens (``kind`` "fuser" or "gpt2") or keys ("keys"); past
    ``SHORT_LENGTH[kind]`` the long route, which takes any head width
    ``hd`` (past 768 columns it streams its operand rows, so its shared
    memory stays bounded) and up to ``LONG_MAX_QUERIES`` queries
    (``n_queries``, else n). Returns whether the long route applies."""
    if n < 1:
        raise ValueError(f"{name}: needs at least one token, got {n}")
    if not long_route(kind, n):
        return False
    queries = n if n_queries is None else n_queries
    if queries > LONG_MAX_QUERIES:
        raise ValueError(
            f"{name}: past {SHORT_LENGTH[kind]} the long attention route "
            f"takes <= {LONG_MAX_QUERIES} queries (hd={hd}, "
            f"queries={queries})")
    return True


class Shard(NamedTuple):
    """A training layer's tensor-parallel shard: model rank ``rank`` of
    ``count``; ``comm`` the model group's collectives, which the shard-mode
    layers place between their launches (``parallel.sharding.ModelComm``:
    ``all_reduce``, ``gather_tokens`` and ``scatter_tokens`` for the
    kernels, Megatron's differentiable ``f`` / ``g`` and their sequence
    forms ``f_seq`` / ``g_seq`` for the plain versions); ``sp``: the layer's
    input and output are this rank's T-shard."""
    rank: int
    count: int
    comm: object = None
    sp: bool = False

    def array(self, part: int, heads: bool):
        """The entries' ``shard`` argument {rank, count, part, heads}."""
        return (ctypes.c_int * 4)(self.rank, self.count, int(part),
                                  int(heads))


def shard_reason(C: int, heads: int, hidden: int, count: int,
                 split_heads: bool = True) -> Optional[str]:
    """Why a layer of width C, ``heads`` heads and ``hidden`` MLP columns
    cannot run sharded over ``count`` model ranks (None: it can): the MLP
    columns and, with ``split_heads``, the heads and C must divide evenly,
    as the JAX package's placement shards a dimension that divides; the
    kernels take any local width."""
    if hidden % count:
        return f"hidden {hidden} does not divide over tp = {count}"
    if split_heads:
        if heads % count:
            return f"the {heads} heads do not divide over tp = {count}"
        if C % count:
            return f"C {C} does not divide over tp = {count}"
    return None


def check_shard(name: str, C: int, heads: int, hidden: int, count: int,
                split_heads: bool = True) -> None:
    """Raise where ``shard_reason`` refuses the shard (a CUDA call)."""
    reason = shard_reason(C, heads, hidden, count, split_heads)
    if reason is not None:
        raise ValueError(f"{name}: no shard mode for this layer: {reason}")


def lead_only(t, rank: int):
    """``t`` on model rank 0; elsewhere zeros whose gradient is ``t``'s, so
    that a replicated tensor added into a partial sum on rank 0 only (a
    row-parallel bias) gets its whole gradient on every rank, as the
    kernels compute it."""
    if t is None or rank == 0:
        return t
    return t - t.detach()


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


# The launches of pack_rows (csrc/gemm_sm90.cuh), which the entries' bf16
# products make inside their own launch sequences for an operand off TMA's
# 16-byte grid; ``launch`` adds them.
PACK_LAUNCHES = {"pack_rows": 0}


def launch(name: str, entry: str, *args, device, pack=None) -> None:
    """Call the C entry point ``entry`` with ``args`` on ``device`` and its
    current stream (the stream is the last argument); raise if it reports
    a launch error. ``pack`` (``pack_scratch``) is the entry's pack arena,
    set on this thread around the call; the pack_rows launches it made are
    counted in ``PACK_LAUNCHES``."""
    with torch.cuda.device(device):
        lib = _build.library()
        if pack is not None:
            lib.afft_set_pack(pack.data_ptr(), pack.numel())
        try:
            err = getattr(lib, entry)(
                *args, torch.cuda.current_stream(device).cuda_stream)
        finally:
            if pack is not None:
                PACK_LAUNCHES["pack_rows"] += lib.afft_set_pack(None, 0)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")


@functools.lru_cache(maxsize=None)
def _tn_slices(I: int, J: int, M: int, index: int) -> int:
    with torch.cuda.device(index):
        return int(_build.library().afft_gemm_tn_slices(I, J, M))


def tn_slices(I: int, J: int, M: int, device) -> int:
    """The slices over M that the Hopper GEMM's TN route takes for the
    weight gradient (I, J) over M rows on a CUDA ``device``
    (``csrc/gemm_sm90.cuh`` ``tn_slices``): 1, but where its output tiles
    would leave most of the card's SMs idle. A caller that gives the route
    scratch gives it ``slices * I * J`` fp32."""
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _tn_slices(I, J, M, index)


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


def gelu_erf_grad(v):
    """d/dv [0.5 v (1 + erf(v / sqrt 2))] in fp32 (common.cuh
    gelu_erf_grad)."""
    return (0.5 * (1.0 + torch.erf(v * 0.70710678118654752))
            + v * 0.3989422804014327 * torch.exp(-0.5 * v * v))


def gelu_tanh_grad(v):
    """The derivative of gelu_new in fp32 (common.cuh gelu_tanh_grad,
    pallas_gpt2_train.py:157-164)."""
    t = torch.tanh(0.79788456080286536 * (v + 0.044715 * v * v * v))
    du = 0.79788456080286536 * (1.0 + 3 * 0.044715 * v * v)
    return 0.5 * (1.0 + t) + 0.5 * v * (1.0 - t * t) * du


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
