"""The bf16 GEMM of ``csrc/gemm_sm90.cuh`` alone: C = A . W with a fused
epilogue for a weight read as (K, N), and the weight gradient out = A^T . B;
the kernels and their plain versions.

The entries run their bf16 products on the wgmma / TMA GEMM from inside
their own launch sequences: the GPT-2 serving halves (``ops.fused_gpt2``),
the GPT-2 training forward, the fuser's training backward dX products and
every training weight gradient (``ops.fused_block_train``,
``ops.fused_gpt2_train``). ``gemm`` and ``gemm_tn`` reach that GEMM alone
(``csrc/gemm.cu``), so that it can be checked and timed on operands of any
shape. No model path calls them.

Epilogues of ``gemm`` (``csrc/common.cuh`` ``Epi``), on ``acc = A . W`` in
fp32: ``bias`` acc + bias (bf16 out, or fp32 with ``out_dtype``);
``bias_res`` res + (acc + bias); ``gelu_tanh`` gelu_new(acc + bias);
``res_drop`` res + ((acc + bias) * drop) * drop_row, with the element
dropout of the training forward's proj site and its drop-path over rows of
``tokens``, also written to out2 with ``stash``; ``pre_gelu_tanh``
gelu_new(acc + bias), out2 the pre-activation; ``gelu_bwd`` acc *
gelu_exact'(res), res the stashed pre-activation. Every output but the fp32
``bias`` is bf16.

Limits of the kernels, which both wrappers apply on every device: K % 8 ==
0 and N % 8 == 0 (I % 8 and J % 8 for ``gemm_tn``); on CUDA, bf16 operands,
contiguous and 16-byte aligned.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._common import (add_bias, check_operands, check_shape, launch,
                      matmul32, ptr)
from .fused_block_train import rate_arrays, rates_operands, site_mask_plain

LAUNCHES = {"gemm": 0, "gemm_tn": 0}

EPILOGUES = {"bias": 0, "bias_res": 1, "gelu_tanh": 3, "res_drop": 4,
             "pre_gelu_tanh": 7, "gelu_bwd": 6}
_NEEDS_RES = ("bias_res", "res_drop", "gelu_bwd")
# the mask sites of the training forward's proj product (train_block.cuh)
_SITE_DROP, _SITE_ROW = 1, 2


def drop_masks(M, N, tokens, seeds, block_idx, drop_rate, dp_rate,
               device="cpu"):
    """The ``res_drop`` multipliers, fp32: per element (M, N) and per row
    (M, 1), the row's drawn over ``row // tokens``."""
    thr, inv = rates_operands(0.0, drop_rate, dp_rate)
    elem = site_mask_plain(M * N, seeds, block_idx, _SITE_DROP, thr[1],
                           inv[1], device).reshape(M, N)
    rows = site_mask_plain(-(-M // tokens), seeds, block_idx, _SITE_ROW,
                           thr[2], inv[2], device)
    return elem, rows.repeat_interleave(tokens)[:M].reshape(M, 1)


def gelu_erf_grad(v):
    """d/dv [0.5 v (1 + erf(v / sqrt 2))] in fp32 (common.cuh
    gelu_erf_grad)."""
    return (0.5 * (1.0 + torch.erf(v * 0.70710678118654752))
            + v * 0.3989422804014327 * torch.exp(-0.5 * v * v))


def gemm_plain(a, w, epi, bias=None, res=None, masks=None, stash=False,
               out_dtype=None):
    """The epilogue in fp32 on the exact products of the bf16 operands;
    returns (out, out2 or None), out in ``out_dtype`` (default a.dtype),
    out2 in a.dtype."""
    dt = a.dtype
    v = add_bias(matmul32(a, w, True), bias)
    out2 = None
    if epi == "gelu_tanh":
        v = F.gelu(v, approximate="tanh")
    elif epi == "pre_gelu_tanh":
        out2 = v.to(dt)
        v = F.gelu(v, approximate="tanh")
    elif epi == "gelu_bwd":
        v = v * gelu_erf_grad(res.float())
    elif epi == "res_drop":
        v = res.float() + (v * masks[0]) * masks[1]
        if stash:
            out2 = v.to(dt)
    elif epi == "bias_res":
        v = res.float() + v
    return v.to(out_dtype or dt), out2


def check_kernel_operands(name, a, operands):
    """What the kernels take on CUDA: bf16 operands (the fp32 products run
    on gemm_f32 / gemm_tn_f32 inside the entries), contiguous and 16-byte
    aligned, all on a's device."""
    if a.dtype != torch.bfloat16:
        raise TypeError(f"{name}: bfloat16 only, got {a.dtype} (the fp32 "
                        "products run on gemm_f32 inside the entries)")
    check_operands(name, a, operands)


def gemm(a, w, epi="bias", bias=None, res=None, *, seeds=(0, 0),
         block_idx=0, drop_rate=0.0, dp_rate=0.0, tokens=1, stash=False,
         out_dtype=None):
    """C = A . W (+ epilogue) for a (M, K) and w (K, N) in bf16; returns
    (out, out2 or None). ``out_dtype=torch.float32`` (``bias`` only) writes
    an fp32 out. CPU tensors take the plain version (on masks from
    ``drop_masks``); CUDA tensors launch the kernel."""
    name = "gemm"
    if epi not in EPILOGUES:
        raise ValueError(f"{name}: epi {epi!r} unknown")
    if out_dtype not in (None, a.dtype) and (
            out_dtype != torch.float32 or epi != "bias"):
        raise ValueError(f"{name}: an fp32 output takes the bias epilogue "
                         f"only (epi {epi!r}, out_dtype {out_dtype})")
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: needs a (M, K) and w (K, N), got "
                         f"{tuple(a.shape)} and {tuple(w.shape)}")
    M, K = a.shape
    N = w.shape[1]
    if M < 1 or N % 8 or K % 8 or N < 8 or K < 8 or tokens < 1:
        raise ValueError(f"{name}: needs M >= 1, K % 8 == 0, N % 8 == 0 and "
                         f"tokens >= 1 (M={M}, N={N}, K={K}, tokens={tokens})")
    if epi in _NEEDS_RES:
        if res is None:
            raise ValueError(f"{name}: epilogue {epi} needs res")
        check_shape(name, "res", res, (M, N))
    check_shape(name, "bias", bias, (N,))
    if a.device.type == "cpu":
        masks = None
        if epi == "res_drop":
            masks = drop_masks(M, N, tokens, seeds, block_idx, drop_rate,
                               dp_rate)
        return gemm_plain(a, w, epi, bias, res, masks, stash, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {a.device}")
    check_kernel_operands(name, a, {"w": w, "bias": bias, "res": res})
    out_f32 = out_dtype == torch.float32
    out = torch.empty((M, N), dtype=torch.float32 if out_f32 else a.dtype,
                      device=a.device)
    out2 = torch.empty((M, N), dtype=a.dtype, device=a.device) if (
        epi == "pre_gelu_tanh" or (epi == "res_drop" and stash)) else None
    launch(name, "afft_gemm", EPILOGUES[epi], int(out_f32), ptr(a), ptr(w),
           ptr(bias), ptr(res), ptr(out), ptr(out2),
           *rate_arrays(seeds, block_idx, 0.0, drop_rate, dp_rate), M, N, K,
           tokens, device=a.device)
    LAUNCHES[name] += 1
    return out, out2


def gemm_tn_plain(a, b):
    """a^T . b in fp32 on the exact products of the operands."""
    return a.float().t() @ b.float()


def gemm_tn(a, b):
    """The weight gradient out (I, J) = a^T . b, fp32, for a (M, I) and b
    (M, J) in bf16, reduced over the M rows. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    name = "gemm_tn"
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"{name}: needs a (M, I) and b (M, J), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    M, I = a.shape
    J = b.shape[1]
    if M < 1 or I % 8 or J % 8 or I < 8 or J < 8:
        raise ValueError(f"{name}: needs M >= 1, I % 8 == 0 and J % 8 == 0 "
                         f"(M={M}, I={I}, J={J})")
    if a.device.type == "cpu":
        return gemm_tn_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {a.device}")
    check_kernel_operands(name, a, {"b": b})
    out = torch.empty((I, J), dtype=torch.float32, device=a.device)
    launch(name, "afft_gemm_tn", ptr(a), ptr(b), ptr(out), I, J, M,
           device=a.device)
    LAUNCHES[name] += 1
    return out
