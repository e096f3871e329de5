"""One bf16 GEMM with a fused epilogue, C = A . W for a Conv1D weight W
(K, N): the kernels and their plain version.

The GPT-2 entries (``ops.fused_gpt2.gpt2_attn_half`` and the forward of
``ops.fused_gpt2_train``) run their bf16 products on the wgmma / TMA GEMM of
``csrc/gemm_sm90.cuh`` from inside their own launch sequences. ``gemm``
reaches that GEMM alone (``csrc/gemm.cu``), so that it can be checked and
timed on operands of any shape. No model path calls it.

Epilogues (``csrc/common.cuh`` ``Epi``), on ``acc = A . W`` in fp32:
``bias`` acc + bias; ``bias_res`` res + (acc + bias); ``res_drop`` res +
((acc + bias) * drop) * drop_row, with the element dropout of the training
forward's proj site and its drop-path over rows of ``tokens``, also written
to out2 with ``stash``; ``pre_gelu_tanh`` gelu_new(acc + bias), out2 the
pre-activation. Every output is bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._common import (add_bias, check_operands, check_shape, launch,
                      matmul32, ptr)
from .fused_block_train import rate_arrays, rates_operands, site_mask_plain

LAUNCHES = {"gemm": 0}

EPILOGUES = {"bias": 0, "bias_res": 1, "res_drop": 4, "pre_gelu_tanh": 7}
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


def gemm_plain(a, w, epi, bias=None, res=None, masks=None, stash=False):
    """The epilogue in fp32 on the exact products of the bf16 operands;
    returns (out, out2 or None) in a.dtype."""
    dt = a.dtype
    v = add_bias(matmul32(a, w, True), bias)
    out2 = None
    if epi == "pre_gelu_tanh":
        out2 = v.to(dt)
        v = F.gelu(v, approximate="tanh")
    elif epi == "res_drop":
        v = res.float() + (v * masks[0]) * masks[1]
        if stash:
            out2 = v.to(dt)
    elif epi == "bias_res":
        v = res.float() + v
    return v.to(dt), out2


def gemm(a, w, epi="bias", bias=None, res=None, *, seeds=(0, 0),
         block_idx=0, drop_rate=0.0, dp_rate=0.0, tokens=1, stash=False):
    """C = A . W (+ epilogue) for a (M, K) and w (K, N) in bf16; returns
    (out, out2 or None). CPU tensors take the plain version (on masks from
    ``drop_masks``); CUDA tensors launch the kernel."""
    name = "gemm"
    if epi not in EPILOGUES:
        raise ValueError(f"{name}: epi {epi!r} unknown")
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: needs a (M, K) and w (K, N), got "
                         f"{tuple(a.shape)} and {tuple(w.shape)}")
    M, K = a.shape
    N = w.shape[1]
    if epi in ("bias_res", "res_drop"):
        if res is None:
            raise ValueError(f"{name}: epilogue {epi} needs res")
        check_shape(name, "res", res, (M, N))
    check_shape(name, "bias", bias, (N,))
    if a.device.type == "cpu":
        masks = None
        if epi == "res_drop":
            masks = drop_masks(M, N, tokens, seeds, block_idx, drop_rate,
                               dp_rate)
        return gemm_plain(a, w, epi, bias, res, masks, stash)
    if a.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {a.device}")
    if a.dtype != torch.bfloat16:
        raise TypeError(f"{name}: bfloat16 only (the fp32 products run on "
                        "gemm_f32 inside the entries)")
    if M < 1 or N % 8 or K % 8 or N < 8 or K < 8 or tokens < 1:
        raise ValueError(f"{name}: needs M >= 1, K % 8 == 0, N % 8 == 0 and "
                         f"tokens >= 1 (M={M}, N={N}, K={K}, tokens={tokens})")
    check_operands(name, a, {"w": w, "bias": bias, "res": res})
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    out2 = torch.empty_like(out) if epi == "pre_gelu_tanh" or (
        epi == "res_drop" and stash) else None
    launch(name, "afft_gemm", EPILOGUES[epi], ptr(a), ptr(w),
           ptr(bias), ptr(res), ptr(out), ptr(out2),
           *rate_arrays(seeds, block_idx, 0.0, drop_rate, dp_rate), M, N, K,
           tokens, device=a.device)
    LAUNCHES[name] += 1
    return out, out2
