"""One pre-LN fuser block in training mode: CUDA kernels (forward and two
backward halves), the mask generator, and their plain versions.

Replaces ``afft_tpu/ops/pallas_block_train.py``: ``fused_block_train``
(``_fwd_kernel``, ``_bwd_mlp_kernel``, ``_bwd_attn_kernel``) and
``draw_masks`` (``_masks_kernel``). The block is the serving block
(``ops.fused_block``) with dropout on the attention probabilities, on the
proj and MLP outputs, and per-row drop-path on both branches.

``fused_block_train`` is differentiable in ``x`` and the block's parameters.
On CUDA tensors it is a ``torch.autograd.Function`` (``BlockTrainFunction``,
which ``ops.fused_gpt2_train`` shares): the forward launches
``csrc/fused_block_train.cu`` and saves ``x, y, qkv, pre1`` (the residuals
the TPU kernel stashes, in the working dtype); the backward launches the MLP
half, then the attention half, and returns ``dx`` and the parameter
gradients (computed in fp32, handed back in each parameter's dtype; ``None``
for an absent bias or affine). On CPU tensors it draws the masks with
``draw_masks_plain`` and runs ``fused_block_train_plain`` under autograd.

In bf16 every product of the three entries runs on the Hopper GEMM
(``csrc/gemm_sm90.cuh``): the forward reads the nn.Linear (out, in) weights
where they lie, as its K-major (N, K) operand, the backward's dX reads them
as (K, N), the weight gradients take its TN route (the attention branch's
split over M into scratch this module allocates, ``_common.tn_slices``);
the forward attention is ``csrc/fuser_attention.cuh``'s rows kernel with
dropout, the attention backward ``csrc/attention_bwd.cuh``, which also
recomputes the forward's attention output for dWproj; past 8 tokens (32 for
the GPT-2 layer) both take the long route of ``csrc/long_attention.cuh``,
whose backward needs stats / dsum scratch (``long_scratch``) and recomputes
its own forward's output (``attention_drop`` and ``attention_drop_bwd``
reach those kernels alone, for their checks; ``attention_drop_bwd_plain``
is the backward's plain version). So a CUDA call takes the GEMM's operand
rules, which ``block_operands`` applies and raises on: one dtype (bf16, or
fp32 for the parity checks, on the fp32 GEMM), contiguous and 16-byte
aligned tensors, any C and hidden (a product whose rows are off TMA's
16-byte grid packs its operands into the launch's scratch,
``_common.pack_scratch``); and the length rule of
``_common.check_length``.

Masks. Each dropout multiplier (0 or 1 / keep) is a pure function of (two
seed words, block index, site, logical element index): a Philox4x32-10 draw
with key (seed0, seed1) and counter (index low, index high, block, site),
whose top 24 bits are compared with a 24-bit keep threshold (the TPU
kernel's thresholds and scales, ``pallas_block_train.py:478-487``). The TPU
kernel seeds its on-core generator per row tile, so its masks depend on the
tile size; here a mask depends on nothing but the element's own index, and
the kernels draw it in registers wherever it is needed, forward and backward.
Element indices: attention ``((r * H + h) * N + tq) * N + tk``; proj and MLP
``(r * N + t) * C + c``; drop-path ``r``, where r is the row of the global
batch: a process of a data-parallel step holding rows ``row0 ..`` of it
passes ``row0``, and its masks are those rows' masks of the one-process
step. ``draw_masks`` exports the five masks; ``draw_masks_plain`` is the
same generator in torch integer ops and equals the kernel bit for bit.

Cast chain (``pallas_block_train.py:200-239``): as ``ops.fused_block``, and
``y`` is fp32 inside the forward but stashed in the working dtype, ``pre1``
is stashed rounded and the GELU is taken from the fp32 value in the forward
and from the stash in the backward.
"""

from __future__ import annotations

import ctypes
import math
from functools import partial
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ._common import (DTYPE_CODES, LONG_LAUNCHES, add_bias, check_heads,
                      check_length, check_operands, check_shard,
                      gelu_erf_grad, gelu_tanh_grad, launch, layer_norm32,
                      lead_only, long_route, mask_operand, matmul32,
                      pack_scratch, ptr, ptr_array, tn_slices)
from .fused_block import _unpack, block_operands

LAUNCHES = {"fused_block_train_fwd": 0, "fused_block_train_bwd_mlp": 0,
            "fused_block_train_bwd_attn": 0, "draw_masks": 0,
            "attention_drop": 0, "attention_drop_bwd": 0,
            "draw_site_mask": 0, "drop_grad": 0}

# the launches in shard mode (tensor parallelism) of both training layers'
# entries, by entry; each is counted in its layer's LAUNCHES too
TP_LAUNCHES = {f"{name}_{entry}": 0
               for name in ("fused_block_train", "fused_gpt2_train")
               for entry in ("fwd", "bwd_mlp", "bwd_attn")}

# csrc/train_block.cuh Part: the forward's halves
PART_BOTH, PART_ATTN, PART_MLP = 0, 1, 2

# the five mask sites (pallas_block_train.py:56), in the order of every mask
# tuple: attention, proj, drop-path 1, MLP, drop-path 2; and the rate each
# draws with: 0 attention | 1 proj and MLP dropout | 2 drop-path
_RATE_OF_SITE = (0, 1, 2, 1, 2)

_TWO24 = 1 << 24
_M32 = 0xFFFFFFFF
COLSUM_SLICES = 128  # csrc/common.cuh CS_SLICES


def rates_operands(attn_rate, drop_rate, dp_rate):
    """Rates -> (24-bit keep thresholds, 1 / keep scales): index 0 the
    attention probabilities, 1 proj and MLP dropout, 2 drop-path."""
    keeps = [1.0 - attn_rate, 1.0 - drop_rate, 1.0 - dp_rate]
    thr = [min(_TWO24, int(round(k * _TWO24))) for k in keeps]
    inv = [1.0 / k if k > 0 else 0.0 for k in keeps]
    return thr, inv


def check_seeds(seeds):
    seeds = [int(s) for s in seeds]
    if len(seeds) != 2 or not all(0 <= s <= _M32 >> 1 for s in seeds):
        raise ValueError(f"seeds must be two ints in [0, 2^31), got {seeds}")
    return seeds


# -- the generator in torch integer ops ---------------------------------------

def _mulhilo(const: int, b):
    """(high, low) 32-bit words of const * b for an int64 tensor b < 2^32,
    through 16-bit halves so no product leaves int64."""
    t = (b & 0xFFFF) * const
    s = (b >> 16) * const + (t >> 16)
    return s >> 16, ((s & 0xFFFF) << 16) | (t & 0xFFFF)


def philox_word0(idx, seed0: int, seed1: int, block: int, site: int):
    """First output word of Philox4x32-10 for each int64 element index."""
    c0, c1 = idx & _M32, idx >> 32
    c2 = torch.full_like(idx, block)
    c3 = torch.full_like(idx, site)
    k0, k1 = seed0, seed1
    for _ in range(10):
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & _M32
        k1 = (k1 + 0xBB67AE85) & _M32
    return c0


def site_mask_plain(n: int, seeds, block_idx: int, site: int, thr: int,
                    inv: float, device="cpu", offset: int = 0, span: int = 0,
                    gap: int = 0):
    """The multipliers of a site's local elements 0 .. n - 1, fp32 (n,):
    local element i is logical element offset + i, moved on by (i // span)
    * gap where ``span`` is not 0 (``csrc/common.cuh`` DropSite: a
    tensor-parallel shard's span / gap remap, ``offset`` its base)."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    if span:
        idx = idx + idx // span * gap
    idx = idx + offset
    draw = philox_word0(idx, seeds[0], seeds[1], block_idx, site) >> 8
    scale = torch.tensor(inv, dtype=torch.float32, device=device)
    return torch.where(draw < thr, scale, torch.zeros_like(scale))


def _mask_shapes(R, N, C, H):
    return ((R, H, N, N), (R * N, C), (R,), (R * N, C), (R,))


def masks_plain(shapes, sites, rate_of_site, seeds, block_idx, thr, inv,
                row0, device):
    """One mask per site, each of its shape (R, elements of a row), starting
    at the global batch's row ``row0``."""
    out = []
    for site, kind, shape in zip(sites, rate_of_site, shapes):
        n = math.prod(shape)
        offset = row0 * (n // shape[0]) if shape[0] else 0
        out.append(site_mask_plain(n, seeds, block_idx, site, thr[kind],
                                   inv[kind], device, offset).reshape(shape))
    return tuple(out)


def draw_masks_plain(R, N, C, num_heads, seeds, block_idx, attn_rate,
                     drop_rate, dp_rate, device="cpu", row0: int = 0):
    """The five masks of one block, already scaled by 1 / keep, fp32:
    attention (R, H, N, N), proj (R * N, C), drop-path 1 (R), MLP (R * N, C),
    drop-path 2 (R), of rows ``row0 .. row0 + R - 1`` of the global batch.
    The generator in torch ops, on any device."""
    seeds = check_seeds(seeds)
    thr, inv = rates_operands(attn_rate, drop_rate, dp_rate)
    shapes = _mask_shapes(R, N, C, num_heads)
    masks = masks_plain([(R, math.prod(s) // max(R, 1)) for s in shapes],
                        range(5), _RATE_OF_SITE, seeds, block_idx, thr, inv,
                        check_row0(row0), device)
    return tuple(m.reshape(shape) for m, shape in zip(masks, shapes))


def check_row0(row0) -> int:
    row0 = int(row0)
    if not 0 <= row0 <= _M32 >> 1:
        raise ValueError(f"row0 must be in [0, 2^31), got {row0}")
    return row0


def rate_arrays(seeds, block_idx, attn_rate, drop_rate, dp_rate, row0=0):
    seeds = check_seeds(seeds)
    thr, inv = rates_operands(attn_rate, drop_rate, dp_rate)
    return ((ctypes.c_int * 4)(seeds[0], seeds[1], int(block_idx),
                               check_row0(row0)),
            (ctypes.c_int * 3)(*thr), (ctypes.c_float * 3)(*inv))


def draw_masks(R, N, C, num_heads, seeds, block_idx, attn_rate, drop_rate,
               dp_rate, device="cuda", row0: int = 0):
    """The five masks as ``draw_masks_plain``: the plain version on the CPU,
    the kernel on a CUDA device."""
    device = torch.device(device)
    if device.type == "cpu":
        return draw_masks_plain(R, N, C, num_heads, seeds, block_idx,
                                attn_rate, drop_rate, dp_rate, row0=row0)
    if device.type != "cuda":
        raise ValueError(f"draw_masks: unsupported device {device}")
    arrays = rate_arrays(seeds, block_idx, attn_rate, drop_rate, dp_rate,
                         row0)
    masks = tuple(torch.empty(shape, dtype=torch.float32, device=device)
                  for shape in _mask_shapes(R, N, C, num_heads))
    launch("draw_masks", "afft_draw_masks", *arrays, ptr_array(masks), R, N,
           C, num_heads, device=device)
    LAUNCHES["draw_masks"] += 1
    return masks


def draw_site_mask(n, seeds, block_idx, site, rate, *, offset=0, span=0,
                   gap=0, device="cuda"):
    """One site's multipliers (``site_mask_plain``'s, with its remap) from
    the mask kernel of ``draw_masks``: the plain version on the CPU, the
    kernel on a CUDA device. No path draws through it: it reaches every
    field of the kernel's site (any offset, a shard's span / gap) for the
    checks."""
    seeds = check_seeds(seeds)
    thr, inv = rates_operands(rate, rate, rate)
    device = torch.device(device)
    if not 0 <= site < 5 or min(n, offset, span, gap) < 0:
        raise ValueError("draw_site_mask: site in 0..4 and n, offset, span, "
                         "gap >= 0")
    if device.type == "cpu":
        return site_mask_plain(n, seeds, block_idx, site, thr[0], inv[0],
                               offset=offset, span=span, gap=gap)
    if device.type != "cuda":
        raise ValueError(f"draw_site_mask: unsupported device {device}")
    out = torch.empty(n, dtype=torch.float32, device=device)
    words = (ctypes.c_int * 4)(seeds[0], seeds[1], int(block_idx), site)
    launch("draw_site_mask", "afft_draw_mask_site", words, thr[0], inv[0],
           offset, span, gap, ptr(out), n, device=device)
    LAUNCHES["draw_site_mask"] += 1
    return out


# the sites (element dropout, drop-path) of a branch's drop pass
_BRANCH_SITES = {"attn": (1, 2), "mlp": (3, 4)}


def drop_grad_plain(d, seeds, block_idx, drop_rate, dp_rate, *, branch,
                    row0: int = 0):
    """(d * the drop-path multiplier of its row) * the element's dropout
    multiplier, rounded to d's dtype, for d (R, N, C): the gradient that
    enters a branch's last product in the backward entries (``branch``
    "attn": the proj and drop-path 1 sites; "mlp": the MLP and drop-path 2
    sites)."""
    R, N, C = d.shape
    seeds = check_seeds(seeds)
    thr, inv = rates_operands(0.0, drop_rate, dp_rate)
    site, dp_site = _BRANCH_SITES[branch]
    elem, rows = masks_plain(((R, N * C), (R, 1)), (site, dp_site), (1, 2),
                             seeds, block_idx, thr, inv, check_row0(row0),
                             d.device)
    return ((d.float() * rows.reshape(R, 1, 1))
            * elem.reshape(R, N, C)).to(d.dtype)


def drop_grad(d, seeds, block_idx, drop_rate, dp_rate, *, branch,
              row0: int = 0):
    """``drop_grad_plain`` through the backward entries' drop pass
    (``csrc/train_block.cuh`` drop_grad) on a CUDA tensor, the plain
    version on a CPU one. No path calls it: the backward entries launch the
    pass themselves; it serves the checks and the pass's timing."""
    if branch not in _BRANCH_SITES:
        raise ValueError(f"drop_grad: branch 'attn' or 'mlp', got {branch!r}")
    if d.device.type == "cpu":
        return drop_grad_plain(d, seeds, block_idx, drop_rate, dp_rate,
                               branch=branch, row0=row0)
    if d.device.type != "cuda" or d.dtype not in DTYPE_CODES or \
            d.dim() != 3 or not d.is_contiguous():
        raise ValueError("drop_grad: a contiguous (R, N, C) fp32 or bf16 "
                         "CUDA tensor")
    R, N, C = d.shape
    arrays = rate_arrays(seeds, block_idx, 0.0, drop_rate, dp_rate, row0)
    out = torch.empty_like(d)
    launch("drop_grad", "afft_drop_grad", DTYPE_CODES[d.dtype], ptr(d),
           ptr(out), *arrays, R, N, C, 0 if branch == "attn" else 1,
           device=d.device)
    LAUNCHES["drop_grad"] += 1
    return out


# -- the plain version --------------------------------------------------------

def _token_rows(dp, R, N):
    """(R,) -> one multiplier for each of a row's N tokens, (R * N, 1)."""
    return dp.reshape(R, 1).expand(R, N).reshape(R * N, 1)


def _heads(t, R, N, H):
    """(R * N, H * hd) rows -> (R, H, N, hd)."""
    return t.reshape(R, N, H, -1).permute(0, 2, 1, 3)


def _rows(t):
    """(R, H, N, hd) -> (R * N, H * hd) rows."""
    R, H, N, hd = t.shape
    return t.permute(0, 2, 1, 3).reshape(R * N, H * hd)


def _probabilities(qkv, mask, n_tokens: int, num_heads: int):
    """(q, k, v) as (R, H, N, hd) fp32 and softmax(q k^T * hd^-0.5 + mask)
    in fp32."""
    rows, three_c = qkv.shape
    R, N, H = rows // n_tokens, n_tokens, num_heads
    q, k, v = (_heads(t, R, N, H) for t in qkv.float().chunk(3, dim=1))
    s = (q @ k.transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    if mask is not None:
        s = s + mask.float()
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    return q, k, v, e / e.sum(dim=-1, keepdim=True)


def attention_drop_plain(qkv, mask, mattn, n_tokens: int, num_heads: int,
                         round_to=None):
    """The training attention on (R * N, 3C) qkv rows ([q | k | v], heads
    minor) in the working dtype: softmax(q k^T * hd^-0.5 + mask) in fp32,
    each probability scaled by its multiplier in ``mattn`` (R, H, N, N),
    unrounded (the fuser, pallas_block_train.py:156-187) or rounded to
    ``round_to`` (the GPT-2 layer, pallas_gpt2_train.py:113-120), before
    P . V. Returns (R * N, C) fp32."""
    _, _, v, p = _probabilities(qkv, mask, n_tokens, num_heads)
    pd = p * mattn
    if round_to is not None:
        pd = pd.to(round_to).float()
    return _rows(pd @ v)


def attention_drop_bwd_plain(qkv, mask, mattn, dao, n_tokens: int,
                             num_heads: int, round_to=None):
    """The attention backward of both training layers (the plain version of
    ``csrc/attention_bwd.cuh``): from the qkv rows and masks of
    ``attention_drop_plain`` and dao = d(attention output) (R * N, C),
    returns (the forward's output O (R * N, C), the packed dqkv (R * N,
    3C)), both fp32: dv = (p * keep)^T . dao, dp = (dao . v^T) * keep, ds =
    p * (dp - sum dp * p), dq = ds . k * hd^-0.5, dk = ds^T . q * hd^-0.5.
    With ``round_to`` (the GPT-2 layer's working dtype) dao is read rounded
    and p * keep and ds are rounded before their products
    (pallas_gpt2_train.py:283-288); without it every step is fp32
    (pallas_block_train.py:397-430)."""
    def rnd(t):
        return t if round_to is None else t.to(round_to).float()
    q, k, v, p = _probabilities(qkv, mask, n_tokens, num_heads)
    R, H, N, hd = q.shape
    pd = rnd(p * mattn)
    g = _heads(rnd(dao.float()), R, N, H)
    dp = (g @ v.transpose(-1, -2)) * mattn
    ds = rnd(p * (dp - (dp * p).sum(dim=-1, keepdim=True)))
    scale = hd ** -0.5
    dqkv = torch.cat([_rows((ds @ k) * scale),
                      _rows((ds.transpose(-1, -2) @ q) * scale),
                      _rows(pd.transpose(-1, -2) @ g)], dim=1)
    return _rows(pd @ v), dqkv


def _kind(gpt2: bool) -> str:
    """A training layer's kind in the length rule (``check_length``)."""
    return "gpt2" if gpt2 else "fuser"


def long_scratch(like, R, N, H, gpt2):
    """The long route's backward scratch of a layer over (R, N) tokens and H
    heads: (stats (R * H * N, 2), dsum (R * H * N)) fp32, allocated through
    PyTorch (so a captured graph owns them), or (None, None) where the
    short kernels take N."""
    if not long_route(_kind(gpt2), N):
        return None, None
    return (torch.empty((R * H * N, 2), dtype=torch.float32,
                        device=like.device),
            torch.empty(R * H * N, dtype=torch.float32, device=like.device))


def _attention_operands(name, qkv, mask, dao, n_tokens, num_heads, gpt2):
    """Check the attention kernels' operands; returns (R, hd, the fp32
    mask or None)."""
    rows, three_c = qkv.shape if qkv.dim() == 2 else (0, 0)
    if qkv.dim() != 2 or three_c % 3 or n_tokens < 1 or rows % n_tokens:
        raise ValueError(f"{name}: needs qkv (R * N, 3C) with N >= 1, got "
                         f"{tuple(qkv.shape)}, N={n_tokens}")
    hd = check_heads(name, three_c // 3, num_heads)
    check_length(name, _kind(gpt2), n_tokens, hd)
    if dao is not None:
        if tuple(dao.shape) != (rows, three_c // 3) \
                or dao.dtype != torch.float32:
            raise ValueError(f"{name}: dao must be fp32 {(rows, three_c // 3)}"
                             f", got {dao.dtype} {tuple(dao.shape)}")
    return rows // n_tokens, hd, mask_operand(name, mask, n_tokens,
                                              qkv.device)


def attention_drop(qkv, mask, seeds, *, n_tokens: int, num_heads: int,
                   block_idx: int = 0, attn_rate: float = 0.0,
                   gpt2: bool = False):
    """The training layers' forward attention alone, with dropout at the
    attention site of ``seeds`` / ``block_idx``: (R * N, C) in qkv.dtype.
    ``gpt2`` takes the GPT-2 layer's arithmetic (p * keep rounded), else the
    fuser's. CPU tensors take ``attention_drop_plain`` on the masks of
    ``draw_masks_plain``; CUDA tensors launch the kernel the entries launch
    (``staged_attention`` / ``fuser_attention_rows``; past 32 / 8 tokens
    ``long_attention``). No model path calls it: the entries launch the
    kernel inside their own sequences."""
    name = "attention_drop"
    R, hd, mask32 = _attention_operands(name, qkv, mask, None, n_tokens,
                                        num_heads, gpt2)
    C, dt = qkv.shape[1] // 3, qkv.dtype
    if qkv.device.type == "cpu":
        mattn = draw_masks_plain(R, n_tokens, C, num_heads, seeds, block_idx,
                                 attn_rate, 0.0, 0.0)[0]
        return attention_drop_plain(qkv, mask, mattn, n_tokens, num_heads,
                                    dt if gpt2 else None).to(dt)
    check_operands(name, qkv, {})
    out = torch.empty((R * n_tokens, C), dtype=dt, device=qkv.device)
    launch(name, "afft_attention_drop", DTYPE_CODES[dt], int(gpt2), ptr(qkv),
           ptr(mask32), ptr(out),
           *rate_arrays(seeds, block_idx, attn_rate, 0.0, 0.0), R, n_tokens,
           num_heads, hd, device=qkv.device)
    LAUNCHES[name] += 1
    LONG_LAUNCHES[name] += long_route(_kind(gpt2), n_tokens)
    return out


def attention_drop_bwd(qkv, mask, dao, seeds, *, n_tokens: int,
                       num_heads: int, block_idx: int = 0,
                       attn_rate: float = 0.0, gpt2: bool = False):
    """The training layers' attention backward alone: from qkv (R * N, 3C)
    and dao (R * N, C) fp32, (the forward's output O (R * N, C), dqkv (R *
    N, 3C)) in qkv.dtype, with the arithmetic of ``attention_drop``. CPU
    tensors take ``attention_drop_bwd_plain``; CUDA tensors launch
    ``csrc/attention_bwd.cuh`` (past 8 / 32 tokens the long route of
    ``csrc/long_attention.cuh``), the kernels the two attention-backward
    entries launch inside their own sequences (no model path calls this)."""
    name = "attention_drop_bwd"
    R, hd, mask32 = _attention_operands(name, qkv, mask, dao, n_tokens,
                                        num_heads, gpt2)
    C, dt = qkv.shape[1] // 3, qkv.dtype
    if qkv.device.type == "cpu":
        mattn = draw_masks_plain(R, n_tokens, C, num_heads, seeds, block_idx,
                                 attn_rate, 0.0, 0.0)[0]
        out, dqkv = attention_drop_bwd_plain(qkv, mask, mattn, dao, n_tokens,
                                             num_heads, dt if gpt2 else None)
        return out.to(dt), dqkv.to(dt)
    check_operands(name, qkv, {})
    if dao.device != qkv.device or not dao.is_contiguous() \
            or dao.data_ptr() % 16:
        raise ValueError(f"{name}: dao must be contiguous, 16-byte aligned "
                         f"and on {qkv.device}")
    out = torch.empty((R * n_tokens, C), dtype=dt, device=qkv.device)
    dqkv = torch.empty_like(qkv)
    stats, dsum = long_scratch(qkv, R, n_tokens, num_heads, gpt2)
    launch(name, "afft_attention_drop_bwd", DTYPE_CODES[dt], int(gpt2),
           ptr(qkv), ptr(mask32), ptr(dao), ptr(dqkv), ptr(out), ptr(stats),
           ptr(dsum), *rate_arrays(seeds, block_idx, attn_rate, 0.0, 0.0),
           R, n_tokens, num_heads, hd, device=qkv.device)
    LAUNCHES[name] += 1
    LONG_LAUNCHES[name] += stats is not None
    return out, dqkv


def attn_half_train_plain(x, params, mask, masks, *, num_heads: int,
                          eps: float = 1e-6):
    """x (R, N, C) -> (the fp32 residual stream y (R * N, C), qkv as the
    forward rounds it): LN1, qkv, attention with dropout on the
    probabilities, proj with dropout and drop-path, + x."""
    R, N, C = x.shape
    dt = x.dtype
    ln1g, ln1b, wqkv, bqkv, wproj, bproj = _unpack(params)[:6]
    mattn, mproj, dp1 = masks[:3]
    x32 = x.reshape(R * N, C).float()
    xn = layer_norm32(x32, ln1g, ln1b, eps).to(dt)
    qkv = add_bias(matmul32(xn, wqkv, False), bqkv).to(dt)
    attn = attention_drop_plain(qkv, mask, mattn, N, num_heads).to(dt)
    proj = add_bias(matmul32(attn, wproj, False), bproj)
    return x32 + _token_rows(dp1, R, N) * (proj * mproj), qkv


def mlp_half_train_plain(y, params, masks, dt, n_tokens: int, *,
                         eps: float = 1e-6):
    """The fp32 residual stream y (R * N, C) -> (out (R * N, C) in ``dt``,
    the fp32 pre-activation): LN2, fc1, exact GELU, fc2 with dropout and
    drop-path, + y."""
    ln2g, ln2b, wfc1, bfc1, wfc2, bfc2 = _unpack(params)[6:]
    mmlp, dp2 = masks[3:]
    R = y.shape[0] // n_tokens
    g = layer_norm32(y, ln2g, ln2b, eps).to(dt)
    pre1 = add_bias(matmul32(g, wfc1, False), bfc1)
    h1 = F.gelu(pre1).to(dt)
    h2 = add_bias(matmul32(h1, wfc2, False), bfc2)
    return (y + _token_rows(dp2, R, n_tokens) * (h2 * mmlp)).to(dt), pre1


def mlp_half_shard_plain(y, params, masks, dt, n_tokens: int, rank: int, *,
                         eps: float = 1e-6):
    """``mlp_half_train_plain`` on model rank ``rank``'s shard of the MLP
    (fc1's rows, fc2's columns: ``parallel.sharding``): the fp32 partial sum
    (R * N, C) of fc2 through the masks, the residual y and fc2's bias added
    on rank 0 only. Summed over the ranks and rounded it is the whole MLP
    half's output. The bias's gradient is the whole one on every rank
    (``lead_only``), as the kernel computes it."""
    ln2g, ln2b, wfc1, bfc1, wfc2, bfc2 = _unpack(params)[6:]
    mmlp, dp2 = masks[3:]
    R = y.shape[0] // n_tokens
    g = layer_norm32(y, ln2g, ln2b, eps).to(dt)
    h1 = F.gelu(add_bias(matmul32(g, wfc1, False), bfc1)).to(dt)
    h2 = add_bias(matmul32(h1, wfc2, False), lead_only(bfc2, rank))
    part = _token_rows(dp2, R, n_tokens) * (h2 * mmlp)
    return y + part if rank == 0 else part


def fused_block_train_shard_plain(x, params, mask, masks, *, num_heads: int,
                                  shard, eps: float = 1e-6):
    """The training block on model rank ``shard.rank``'s shard in
    differentiable PyTorch ops: the attention half whole, the MLP half's
    partial sum (``mlp_half_shard_plain``) summed over the model group
    (``shard.comm.g``; Megatron's g) and rounded. The input reaches the MLP
    half through ``shard.comm.f`` (Megatron's f: the gradient summed over
    the group). ``attn_half_train_plain`` and ``mlp_half_shard_plain`` give
    the partial sum without a process group."""
    R, N, C = x.shape
    dt = x.dtype
    if shard.sp:
        raise ValueError("fused_block_train: sequence parallelism covers "
                         "the GPT-2 predictor only")
    y, _ = attn_half_train_plain(x, params, mask, masks,
                                 num_heads=num_heads, eps=eps)
    y = shard.comm.f(y)
    part = mlp_half_shard_plain(y, params, masks, dt, N, shard.rank, eps=eps)
    return shard.comm.g(part).to(dt).reshape(R, N, C)


def _block_train_fwd_plain(x, params, mask, masks, num_heads, eps):
    """The training block's forward in PyTorch ops: (out (R, N, C), and
    the stashed y, qkv, pre1), all in x.dtype."""
    R, N, C = x.shape
    dt = x.dtype
    y, qkv = attn_half_train_plain(x, params, mask, masks,
                                   num_heads=num_heads, eps=eps)
    out, pre1 = mlp_half_train_plain(y, params, masks, dt, N, eps=eps)
    return out.reshape(R, N, C), y.to(dt), qkv, pre1.to(dt)


def _ln_stats32(x32, eps):
    """LayerNorm's (xhat, rstd) of fp32 rows."""
    mu = x32.mean(-1, keepdim=True)
    rstd = torch.rsqrt((x32 - mu).square().mean(-1, keepdim=True) + eps)
    return (x32 - mu) * rstd, rstd


def _ln_bwd32(dout, xhat, rstd, weight):
    """LayerNorm's input gradient from dout (fp32) at its output, and its
    affine's gradients (weight, bias)."""
    dxhat = dout if weight is None else dout * weight.float()
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return dx, (dout * xhat).sum(0), dout.sum(0)


def block_train_bwd_plain(x, y, qkv, pre1, dout, tensors, mask, masks, *,
                          num_heads: int, eps: float, gpt2: bool = False):
    """The plain version of a training layer's two backward kernels (8,
    then 9; or the GPT-2 layer's, 13 + 14, then 15) with their cast chain
    (``csrc/train_block.cuh``; ``pallas_block_train.py:260-330``,
    ``pallas_gpt2_train.py:225-330``): from x, the stashed y, qkv, pre1 and
    dout (all in the working dtype), the MLP half recomputes LN2 from the
    stashed y and the GELU from the stashed pre1; dh2, dpre1, dy, dproj and
    dqkv are rounded to the working dtype, dh1, dg, dxn and the attention's
    d(output) stay fp32 (the fp32 products of ``_dot``) and the attention
    backward is ``attention_drop_bwd_plain``: fp32 in the fuser, with its
    d(output), p * keep and ds rounded in the GPT-2 layer (``gpt2``: also
    HF Conv1D (in, out) weights, gelu_new, no drop-path; ``masks`` its
    three). ``tensors`` in ``_unpack``'s order. Returns (dx in x's shape
    and dtype, the fp32 gradients of ``tensors``, None for an absent
    one)."""
    R, N, C = x.shape
    dt = x.dtype
    rd = dt if gpt2 else None

    def rnd(t):
        return t.to(dt).float()

    def lin_grads(dy, inp, bias):
        """A product's weight (in its own layout) and bias gradients."""
        return (inp.t() @ dy if gpt2 else dy.t() @ inp,
                None if bias is None else dy.sum(0))

    def back(dy, w):
        """d(input) of a product from d(output)."""
        return dy @ (w.float().t() if gpt2 else w.float())

    (ln1g, ln1b, wqkv, bqkv, wproj, bproj, ln2g, ln2b, wfc1, bfc1, wfc2,
     bfc2) = tensors
    if gpt2:
        (mattn, mproj, mmlp), dp1, dp2 = masks, 1.0, 1.0
        gelu, gelu_grad = partial(F.gelu, approximate="tanh"), gelu_tanh_grad
    else:
        mattn, mproj, dp1, mmlp, dp2 = masks
        dp1, dp2 = _token_rows(dp1, R, N), _token_rows(dp2, R, N)
        gelu, gelu_grad = F.gelu, gelu_erf_grad
    do = dout.reshape(R * N, C).float()
    # MLP half
    y32 = y.float()
    xhat2, rstd2 = _ln_stats32(y32, eps)
    g = rnd(layer_norm32(y32, ln2g, ln2b, eps))
    pre = pre1.float()
    dh2 = rnd(do * dp2 * mmlp)
    dw2, db2 = lin_grads(dh2, rnd(gelu(pre)), bfc2)
    dpre1 = rnd(back(dh2, wfc2) * gelu_grad(pre))
    dw1, db1 = lin_grads(dpre1, g, bfc1)
    dyln, dg2, db2ln = _ln_bwd32(back(dpre1, wfc1), xhat2, rstd2, ln2g)
    dy = rnd(do + dyln)
    # attention half
    x32 = x.reshape(R * N, C).float()
    xhat1, rstd1 = _ln_stats32(x32, eps)
    xn = rnd(layer_norm32(x32, ln1g, ln1b, eps))
    attn = rnd(attention_drop_plain(qkv, mask, mattn, N, num_heads, rd))
    dproj = rnd(dy * dp1 * mproj)
    dwproj, dbproj = lin_grads(dproj, attn, bproj)
    dqkv = rnd(attention_drop_bwd_plain(qkv, mask, mattn, back(dproj, wproj),
                                        N, num_heads, rd)[1])
    dwqkv, dbqkv = lin_grads(dqkv, xn, bqkv)
    dxln, dg1, db1ln = _ln_bwd32(back(dqkv, wqkv), xhat1, rstd1, ln1g)
    dx = (dy + dxln).to(dt).reshape(x.shape)
    grads = (dg1, db1ln, dwqkv, dbqkv, dwproj, dbproj, dg2, db2ln, dw1, db1,
             dw2, db2)
    return dx, [None if t is None else gr for t, gr in zip(tensors, grads)]


class PlainBlockTrainFunction(torch.autograd.Function):
    """A training layer's plain version under autograd. ``cfg``: (its
    forward in PyTorch ops, (x, params, mask, masks, num_heads, eps) ->
    (out, and the stashed y, qkv, pre1), its parameter names in
    ``_unpack``'s order, masks, num_heads, eps, gpt2); the backward is
    ``block_train_bwd_plain``, the backward kernels' plain version with
    their cast chain."""

    @staticmethod
    def forward(ctx, x, mask, cfg, *tensors):
        forward, names, masks, num_heads, eps, _ = cfg
        out, y, qkv, pre1 = forward(x, dict(zip(names, tensors)), mask,
                                    masks, num_heads, eps)
        ctx.save_for_backward(x, y, qkv, pre1, mask, *tensors)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, dout):
        x, y, qkv, pre1, mask, *tensors = ctx.saved_tensors
        _, _, masks, num_heads, eps, gpt2 = ctx.cfg
        dx, grads = block_train_bwd_plain(x, y, qkv, pre1, dout, tensors,
                                          mask, masks, num_heads=num_heads,
                                          eps=eps, gpt2=gpt2)
        return (dx, None, None,
                *[None if g is None else g.to(t.dtype)
                  for g, t in zip(grads, tensors)])


# the parameter names in ``_unpack``'s order
_PARAM_NAMES = ("norm1.weight", "norm1.bias", "attn.qkv.weight",
                "attn.qkv.bias", "attn.proj.weight", "attn.proj.bias",
                "norm2.weight", "norm2.bias", "mlp.mlp.0.weight",
                "mlp.mlp.0.bias", "mlp.mlp.2.weight", "mlp.mlp.2.bias")


def fused_block_train_plain(x, params, mask, masks, *, num_heads: int,
                            eps: float = 1e-6, return_residuals=False):
    """The training block in PyTorch ops with the kernel's forward cast
    chain, given the five explicit masks of ``draw_masks`` (the counterpart
    of ``pallas_block_train.block_reference_with_masks``). Returns (R, N, C)
    in x.dtype, differentiable in x and the parameters: its backward is
    ``block_train_bwd_plain``, the backward kernels' plain version with
    their cast chain (``PlainBlockTrainFunction``). With
    ``return_residuals`` the forward alone, with the stashed ``y, qkv,
    pre1``."""
    if return_residuals:
        return _block_train_fwd_plain(x, params, mask, masks, num_heads, eps)
    return PlainBlockTrainFunction.apply(
        x, mask, (_block_train_fwd_plain, _PARAM_NAMES, masks, num_heads, eps,
                  False), *_unpack(params))


# -- the kernels under autograd -----------------------------------------------

def _new(like, *shape, dtype=None):
    return torch.empty(shape, dtype=dtype or like.dtype, device=like.device)


def new_grads(tensors):
    """fp32 gradient buffers for the present parameters."""
    return [None if t is None else _new(t, *t.shape, dtype=torch.float32)
            for t in tensors]


def _bwd_scratch(x, C, hidden):
    M = x.shape[0] * x.shape[1]
    f32 = torch.float32
    return (_new(x, M, C), _new(x, M, C), _new(x, M, C, dtype=f32),
            _new(x, M, dtype=f32), _new(x, M, dtype=f32),
            _new(x, 2 * COLSUM_SLICES * max(3 * C, hidden), dtype=f32))


class Layer(NamedTuple):
    """One kind of training layer on the kernels of
    ``csrc/train_block.cuh``: its C entries ``afft_{entry}_fwd``,
    ``_bwd_mlp``, ``_bwd_attn``, the names its launches are counted under
    (``{name}_fwd`` ...) in ``counts``, and whether its forward keeps an fp32
    residual stream between the halves (the fuser) or rounds it (GPT-2)."""
    name: str
    entry: str
    counts: dict
    fp32_stream: bool


FUSER = Layer("fused_block_train", "block_train", LAUNCHES, True)


def _count(layer, entry, shard, n_tokens):
    key = f"{layer.name}_{entry}"
    layer.counts[key] += 1
    if key in LONG_LAUNCHES:
        LONG_LAUNCHES[key] += long_route(_kind(not layer.fp32_stream),
                                         n_tokens)
    if shard is not None:
        TP_LAUNCHES[key] += 1


def block_train_bwd_mlp(x, y, dout, pre1, tensors, grads, cfg, shard=None):
    """The MLP backward (kernel 8, or the layer's of ``cfg``) on CUDA
    tensors: (stashed y, dout, stashed pre1) -> dy (R * N, C); writes the
    fc1, fc2 and norm2 entries of ``grads``. With ``shard`` (a ``Shard``)
    the entry's shard mode: dy is this rank's fp32 partial sum and the norm2
    gradients partial sums."""
    num_heads, hidden, eps, arrays, layer = cfg
    R, N, C = x.shape
    tmp, dh2, dg, mu, rstd, partial = _bwd_scratch(x, C, hidden)
    h1, dpre1 = _new(x, R * N, hidden), _new(x, R * N, hidden)
    dy = _new(x, R * N, C, dtype=None if shard is None else torch.float32)
    launch(layer.name, f"afft_{layer.entry}_bwd_mlp",
           DTYPE_CODES[x.dtype], ptr(y), ptr(dout), ptr(pre1),
           ptr_array(tensors), ptr_array(grads), *arrays,
           None if shard is None else shard.array(PART_BOTH, False),
           ptr_array([tmp, dh2, h1, dpre1, dg, mu, rstd, partial, dy]),
           R, N, C, hidden, eps, device=x.device,
           pack=pack_scratch(x, R * N, C, hidden))
    _count(layer, "bwd_mlp", shard, N)
    return dy


def tn_scratch(x, shapes, M):
    """Scratch for the TN route's partial tiles over M rows: enough for the
    slices of each (I, J) weight gradient of ``shapes`` (either
    orientation), or None where each takes one slice (and in fp32, whose
    weight gradients need none)."""
    if x.dtype != torch.bfloat16:
        return None
    sizes = [s * I * J for I, J in shapes
             if (s := tn_slices(I, J, M, x.device)) > 1]
    return _new(x, max(sizes), dtype=torch.float32) if sizes else None


def block_train_bwd_attn(x, dy, qkv, mask32, tensors, grads, cfg,
                         shard=None):
    """The attention backward (kernel 9, or the layer's of ``cfg``) on
    CUDA tensors: (x, dy, stashed qkv) -> dx (R, N, C); writes the qkv, proj
    and norm1 entries of ``grads``. With ``shard`` the entry's shard mode
    over the heads (the GPT-2 layer's; ``cfg``'s heads are the local ones):
    dx is this rank's fp32 partial sum and the norm1 gradients partial
    sums."""
    num_heads, hidden, eps, arrays, layer = cfg
    R, N, C = x.shape
    A = qkv.shape[1] // 3
    tmp, dproj, dattn, mu, rstd, partial = _bwd_scratch(x, C, hidden)
    dqkv = _new(x, R * N, 3 * A)
    dx = _new(x, R, N, C, dtype=None if shard is None else torch.float32)
    # dWproj (C, A) or (A, C) and dWqkv (3A, C) or (C, 3A)
    tn = tn_scratch(x, ((C, A), (A, C), (3 * A, C), (C, 3 * A)), R * N)
    stats, dsum = long_scratch(x, R, N, num_heads, not layer.fp32_stream)
    launch(layer.name, f"afft_{layer.entry}_bwd_attn",
           DTYPE_CODES[x.dtype], ptr(x), ptr(dy), ptr(qkv),
           ptr_array(tensors), ptr_array(grads), ptr(mask32), *arrays,
           None if shard is None else shard.array(PART_BOTH, True),
           ptr_array([tmp, dproj, dqkv, dattn, mu, rstd, partial, dx, tn,
                      stats, dsum]),
           R, N, C, num_heads, eps, device=x.device,
           pack=pack_scratch(x, R * N, C, 3 * A))
    _count(layer, "bwd_attn", shard, N)
    return dx


class BlockTrainFunction(torch.autograd.Function):
    """Forward: kernel 7; backward: kernels 8 then 9 (or the GPT-2
    layer's three entries, by the ``Layer`` in ``cfg``)."""

    @staticmethod
    def forward(ctx, x, mask32, cfg, *tensors):
        num_heads, hidden, eps, arrays, layer = cfg
        R, N, C = x.shape
        M = R * N
        out, y = _new(x, R, N, C), _new(x, M, C)
        qkv, pre1 = _new(x, M, 3 * C), _new(x, M, hidden)
        tmp, h1 = _new(x, M, C), _new(x, M, hidden)
        # the fuser's fp32 residual stream; in fp32 the stashed y is that
        # stream
        y32 = _new(x, M, C, dtype=torch.float32) \
            if layer.fp32_stream and x.dtype != torch.float32 else None
        launch(layer.name, f"afft_{layer.entry}_fwd",
               DTYPE_CODES[x.dtype], ptr(x), ptr_array(tensors), ptr(mask32),
               *arrays, None, ptr_array([tmp, y32, h1, out, y, qkv, pre1]),
               R, N, C, num_heads, hidden, eps, device=x.device,
               pack=pack_scratch(x, M, C, 3 * C, hidden))
        _count(layer, "fwd", None, N)
        ctx.save_for_backward(x, y, qkv, pre1, mask32, *tensors)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, dout):
        x, y, qkv, pre1, mask32, *tensors = ctx.saved_tensors
        dout = dout.to(x.dtype).contiguous()
        grads = new_grads(tensors)
        dy = block_train_bwd_mlp(x, y, dout, pre1, tensors, grads, ctx.cfg)
        dx = block_train_bwd_attn(x, dy, qkv, mask32, tensors, grads,
                                  ctx.cfg)
        return (dx, None, None,
                *[None if g is None else g.to(t.dtype)
                  for g, t in zip(grads, tensors)])


def train_fwd_shard(x, mask32, cfg, tensors, shard, part, y=None):
    """One forward launch of a layer's entry in shard mode on CUDA tensors
    (``cfg`` as ``BlockTrainFunction``'s, this shard's heads and hidden
    width): ``part`` PART_ATTN (the GPT-2 attention half: the fp32 partial
    sum of y and the local qkv), PART_MLP (the GPT-2 MLP half on the summed,
    rounded ``y``: the partial output and pre1) or PART_BOTH (the fuser
    block, MLP split: the partial output, y, qkv and pre1). Returns {"part":
    fp32 (R * N, C), and the stashes it writes}."""
    num_heads, hidden, eps, arrays, layer = cfg
    R, N, C = x.shape
    M, dt = R * N, x.dtype
    gpt2 = not layer.fp32_stream
    A = C // shard.count if gpt2 else C
    out = {"part": _new(x, M, C, dtype=torch.float32)}
    tmp, h1, qkv, pre1, y32 = _new(x, M, C), None, None, None, None
    if part != PART_MLP:
        out["qkv"] = qkv = _new(x, M, 3 * A)
    if part != PART_ATTN:
        h1 = _new(x, M, hidden)
        out["pre1"] = pre1 = _new(x, M, hidden)
    if part == PART_BOTH:
        out["y"] = y = _new(x, M, C)
        if dt != torch.float32:
            y32 = _new(x, M, C, dtype=torch.float32)
    launch(layer.name, f"afft_{layer.entry}_fwd", DTYPE_CODES[dt], ptr(x),
           ptr_array(tensors), ptr(mask32), *arrays, shard.array(part, gpt2),
           ptr_array([tmp, y32, h1, out["part"], y, qkv, pre1]), R, N, C,
           num_heads, hidden, eps, device=x.device,
           pack=pack_scratch(x, M, C, 3 * A, hidden))
    _count(layer, "fwd", shard, N)
    return out


def _own_tokens(t, shard):
    """This rank's T-shard of a replicated (R, N, C)."""
    n = t.shape[1] // shard.count
    return t[:, shard.rank * n:(shard.rank + 1) * n].contiguous()


class ShardTrainFunction(torch.autograd.Function):
    """Both training layers in the entries' shard mode (tensor parallelism,
    ``csrc/train_block.cuh``) under autograd, the collectives over
    the model group between the launches (``shard.comm``); ``cfg`` as
    ``BlockTrainFunction``'s with this shard's heads and hidden width.

    - GPT-2 layer (heads and MLP split): forward: the attention half's
      partial y, summed over the group and rounded, then the MLP half's
      partial output, summed and rounded; backward: the MLP entry's partial
      dy, summed and rounded, then the attention entry's partial dx, summed
      and rounded.
    - Fuser block (MLP split): forward: the whole entry, its partial output
      summed and rounded; backward: the MLP entry's partial dy, summed and
      rounded, then the attention entry whole.

    Megatron's f and g are these sums: each is g in the forward (the
    row-parallel output's sum) and f's all-reduce in the backward (a sum of
    partial input gradients). Under sequence parallelism (``shard.sp``) the
    layer's input and output are this rank's T-shard: the input is
    all-gathered over T and the output reduce-scattered over T (the
    backward the other way round); between the halves the T-shards would
    be gathered again at once, so that sum stays an all-reduce. The layer
    keeps its input and y as T-shards for the backward, which gathers them
    again. The norm affine gradients left partial are summed by the caller
    (the runner, over the model group)."""

    @staticmethod
    def forward(ctx, x, mask32, cfg, shard, *tensors):
        layer, comm = cfg[4], shard.comm
        x_in = x
        if shard.sp:
            x = comm.gather_tokens(x).contiguous()
        R, N, C = x.shape
        if not layer.fp32_stream:
            # the GPT-2 layer: the halves, y summed between them
            first = train_fwd_shard(x, mask32, cfg, tensors, shard,
                                    PART_ATTN)
            qkv = first["qkv"]
            y = comm.all_reduce(first.pop("part")).to(x.dtype)
            second = train_fwd_shard(x, mask32, cfg, tensors, shard,
                                     PART_MLP, y)
            part, pre1 = second["part"], second["pre1"]
        else:
            run = train_fwd_shard(x, mask32, cfg, tensors, shard, PART_BOTH)
            part, y, qkv, pre1 = (run[k] for k in ("part", "y", "qkv",
                                                   "pre1"))
        out = part.reshape(R, N, C)
        if shard.sp:
            out = comm.scatter_tokens(out)
            # the stashes of C channels a token kept as T-shards
            x, y = x_in, _own_tokens(y.reshape(R, N, C), shard)
        else:
            out = comm.all_reduce(out)
        ctx.save_for_backward(x, y, qkv, pre1, mask32, *tensors)
        ctx.cfg, ctx.shard = cfg, shard
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, dout):
        x, y, qkv, pre1, mask32, *tensors = ctx.saved_tensors
        shard, comm = ctx.shard, ctx.shard.comm
        gpt2 = not ctx.cfg[4].fp32_stream
        dout = dout.to(x.dtype)
        if shard.sp:
            dout = comm.gather_tokens(dout)
            x = comm.gather_tokens(x).contiguous()
            y = comm.gather_tokens(y).reshape(
                -1, x.shape[-1]).contiguous()
        dout = dout.contiguous()
        grads = new_grads(tensors)
        dy = block_train_bwd_mlp(x, y, dout, pre1, tensors, grads, ctx.cfg,
                                 shard)
        dy = comm.all_reduce(dy).to(x.dtype)
        if gpt2:
            dx = block_train_bwd_attn(x, dy, qkv, mask32, tensors, grads,
                                      ctx.cfg, shard)
            dx = comm.scatter_tokens(dx) if shard.sp \
                else comm.all_reduce(dx)
            dx = dx.to(x.dtype)
        else:
            dx = block_train_bwd_attn(x, dy, qkv, mask32, tensors, grads,
                                      ctx.cfg)
        return (dx, None, None, None,
                *[None if g is None else g.to(t.dtype)
                  for g, t in zip(grads, tensors)])


def fused_block_train(x, params, mask, seeds, *, num_heads: int,
                      block_idx: int = 0, attn_rate: float = 0.0,
                      drop_rate: float = 0.0, dp_rate: float = 0.0,
                      eps: float = 1e-6, row0: int = 0, shard=None):
    """One fuser block in training mode on x (R, N, C); returns (R, N, C) in
    x.dtype, differentiable in x and the parameters. ``seeds`` are the
    step's two seed words (ints in [0, 2^31)), ``block_idx`` the block's
    position in its stack, ``row0`` the global batch's row that x's first
    row is (a data-parallel step's rank offset; its masks follow from it).

    ``shard`` (an ``ops._common.Shard``): ``params`` hold model rank
    ``shard.rank``'s shard of the MLP (``parallel.sharding.shard_state``);
    the call is the whole block's on every rank of the model group, the
    norm2 gradients partial sums.

    CPU tensors take the plain version on masks from ``draw_masks_plain``;
    CUDA tensors launch the kernels."""
    name = "fused_block_train"
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (R, N, C), got {tuple(x.shape)}")
    R, N, C = x.shape
    if x.device.type == "cpu":
        masks = draw_masks_plain(R, N, C, num_heads, seeds, block_idx,
                                 attn_rate, drop_rate, dp_rate, row0=row0)
        if shard is not None:
            return fused_block_train_shard_plain(
                x, params, mask, masks, num_heads=num_heads, shard=shard,
                eps=eps)
        return fused_block_train_plain(x, params, mask, masks,
                                       num_heads=num_heads, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    check_length(name, "fuser", N, check_heads(name, C, num_heads))
    if not x.is_contiguous():
        x = x.contiguous()
    tensors, hidden = block_operands(name, x, params, num_heads,
                                     differentiable=True)
    mask32 = mask_operand(name, mask, N, x.device)
    if R == 0:
        return torch.empty_like(x)
    arrays = rate_arrays(seeds, block_idx, attn_rate, drop_rate, dp_rate,
                         row0)
    if shard is not None:
        if shard.sp:
            raise ValueError(f"{name}: sequence parallelism covers the GPT-2 "
                             "predictor only")
        check_shard(name, C, num_heads, hidden * shard.count,
                       shard.count, split_heads=False)
        return ShardTrainFunction.apply(
            x, mask32, (num_heads, hidden, eps, arrays, FUSER), shard,
            *tensors)
    return BlockTrainFunction.apply(x, mask32,
                                    (num_heads, hidden, eps, arrays, FUSER),
                                    *tensors)
