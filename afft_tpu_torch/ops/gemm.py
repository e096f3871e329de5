"""The bf16 GEMM of ``csrc/gemm_sm90.cuh`` alone: C = A . W with a fused
epilogue for a weight read as (K, N) or, on its K-major B route, as (N, K),
and the weight gradient out = A^T . B; the kernels and their plain
versions.

The entries run their bf16 products on the wgmma / TMA GEMM from inside
their own launch sequences: the fuser blocks' serving forward
(``ops.fused_block``, ``ops.fused_seq_block``, every stage of
``fused_decoder_block`` included: the nn.Linear (out, in) weights as (N,
K)), the GPT-2 serving halves (``ops.fused_gpt2``), and
every product of both training layers (``ops.fused_block_train``,
``ops.fused_gpt2_train``): the fuser's forward and the GPT-2 layer's
backward dX with W as (N, K), the GPT-2 layer's forward and the fuser's
backward dX with W as (K, N), the weight gradients on the TN route.
``gemm`` and ``gemm_tn`` reach that GEMM alone
(``csrc/gemm.cu``), so that it can be checked and timed on operands of any
shape. No model path calls them.

Epilogues of ``gemm`` (``csrc/common.cuh`` ``Epi``), on ``acc = A . W`` in
fp32. For W (K, N) (``w_in_out=True``, the Conv1D (in, out) layout):
``bias`` acc + bias (bf16 out, or fp32 with ``out_dtype``); ``bias_res``
res + (acc + bias); ``gelu_tanh`` gelu_new(acc + bias); ``res_drop`` res +
((acc + bias) * drop) * drop_row, with the element dropout of the training
forward's proj site and its drop-path over rows of ``tokens``, also written
to out2 with ``stash``; ``pre_gelu_tanh`` gelu_new(acc + bias), out2 the
pre-activation; ``gelu_bwd`` acc * gelu_exact'(res), res the stashed
pre-activation; every output but the fp32 ``bias`` is bf16. For W (N, K)
(``w_in_out=False``, the nn.Linear (out, in) layout, and the Conv1D weight
in its backward dX): ``bias`` (bf16 out, or fp32: the GPT-2 layer's dg,
dattn, dxn), ``gelu_erf`` gelu_exact(acc + bias), ``pre_gelu``
gelu_exact(acc + bias) with out2 the pre-activation (the fuser's training
fc1), ``gelu_tanh_bwd`` acc * gelu_new'(res) (the GPT-2 layer's dpre1),
and ``bias_res`` and ``res_drop``, whose residual may be fp32 (with a bf16
out: the fuser's fc2 adding the residual stream) or whose out may be fp32
(with a bf16 residual: the fuser's proj into it); ``bias_res`` also with
both fp32, into ``out`` given as the residual itself (the decoder block's
cross proj, y += cross . Wcproj^T + b, in place); ``res_drop`` takes only
the two mixed forms there, the training forward's.

Limits of the kernels, which both wrappers apply on every device: any M, N
and K >= 1 (I and J for ``gemm_tn``), the epilogue and dtype combinations
above; on CUDA, bf16 operands (the fp32 residual and out aside), contiguous
and 16-byte aligned. An operand whose rows are not a multiple of 8 columns
is packed first (``pack_rows``, into the scratch ``_common.pack_scratch``
gives the launch), and an output whose rows are not takes the epilogue's
element-by-element route.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._common import (PACK_LAUNCHES, add_bias, check_operands, check_shape,
                      gelu_erf_grad, gelu_tanh_grad, launch, matmul32,
                      pack_scratch, pad8, ptr, tn_slices)
from .fused_block_train import rate_arrays, rates_operands, site_mask_plain

LAUNCHES = {"gemm": 0, "gemm_tn": 0}

EPILOGUES = {"bias": 0, "bias_res": 1, "gelu_erf": 2, "gelu_tanh": 3,
             "res_drop": 4, "pre_gelu": 5, "gelu_bwd": 6, "pre_gelu_tanh": 7,
             "gelu_tanh_bwd": 8}
# the epilogues of each weight layout (w_in_out: W read as (K, N))
ROUTE_EPILOGUES = {
    True: ("bias", "bias_res", "gelu_tanh", "res_drop", "pre_gelu_tanh",
           "gelu_bwd"),
    False: ("bias", "gelu_erf", "bias_res", "pre_gelu", "gelu_tanh_bwd",
            "res_drop")}
# the epilogues that take an fp32 out on each route, those that take an
# fp32 residual (the (N, K) route's, into a bf16 out), and those that take
# both (the decoder block's cross proj adding into y, in place)
FP32_OUT_EPILOGUES = {True: ("bias",), False: ("bias", "bias_res",
                                               "res_drop")}
FP32_RES_EPILOGUES = ("bias_res", "res_drop")
FP32_RES_OUT_EPILOGUES = ("bias_res",)
_NEEDS_RES = ("bias_res", "res_drop", "gelu_bwd", "gelu_tanh_bwd")
_STASHES = ("pre_gelu", "pre_gelu_tanh")
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


def gemm_plain(a, w, epi, bias=None, res=None, masks=None, stash=False,
               out_dtype=None, w_in_out=True, out=None):
    """The epilogue in fp32 on the exact products of the bf16 operands (w
    read as (K, N), or as (N, K) without ``w_in_out``); returns (out, out2
    or None), out in ``out_dtype`` (default a.dtype), out2 in a.dtype. With
    ``out`` the result is written into it (which may be ``res``)."""
    dt = a.dtype
    v = add_bias(matmul32(a, w, w_in_out), bias)
    out2 = None
    if epi == "gelu_erf":
        v = F.gelu(v)
    elif epi == "pre_gelu":
        out2 = v.to(dt)
        v = F.gelu(v)
    elif epi == "gelu_tanh":
        v = F.gelu(v, approximate="tanh")
    elif epi == "pre_gelu_tanh":
        out2 = v.to(dt)
        v = F.gelu(v, approximate="tanh")
    elif epi == "gelu_bwd":
        v = v * gelu_erf_grad(res.float())
    elif epi == "gelu_tanh_bwd":
        v = v * gelu_tanh_grad(res.float())
    elif epi == "res_drop":
        v = res.float() + (v * masks[0]) * masks[1]
        if stash:
            out2 = v.to(dt)
    elif epi == "bias_res":
        v = res.float() + v
    v = v.to(out_dtype or dt)
    if out is not None:
        out.copy_(v)
        v = out
    return v, out2


def check_kernel_operands(name, a, operands, fp32=None):
    """What the kernels take on CUDA: bf16 operands (the fp32 products run
    on gemm_f32 / gemm_tn_f32 inside the entries), but the float32 ones
    named in ``fp32`` (the fp32 residual), contiguous and 16-byte aligned,
    all on a's device."""
    if a.dtype != torch.bfloat16:
        raise TypeError(f"{name}: bfloat16 only, got {a.dtype} (the fp32 "
                        "products run on gemm_f32 inside the entries)")
    check_operands(name, a, operands)
    for key, t in (fp32 or {}).items():
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} is {t.dtype}, expected "
                            "torch.float32")
        if t.device != a.device:
            raise ValueError(f"{name}: {key} on {t.device}, a on {a.device}")
        check_operands(name, t, {})


def gemm(a, w, epi="bias", bias=None, res=None, *, seeds=(0, 0),
         block_idx=0, drop_rate=0.0, dp_rate=0.0, tokens=1, stash=False,
         out_dtype=None, w_in_out=True, out=None):
    """C = A . W (+ epilogue) for a (M, K) and w (K, N), or w (N, K) with
    ``w_in_out=False`` (the K-major B route), in bf16; returns (out, out2 or
    None). ``out_dtype=torch.float32`` writes an fp32 out (``bias`` on the
    (K, N) route; ``bias``, ``bias_res`` and ``res_drop`` on the (N, K)
    route); on the (N, K) route ``bias_res`` and ``res_drop`` also take an
    fp32 ``res`` into a bf16 out, and ``bias_res`` an fp32 ``res`` into an
    fp32 out. ``out`` (M, N) of the output's dtype receives the result; it
    may be ``res`` itself (the decoder block's cross proj, y += ...). CPU
    tensors take the plain version (on masks from ``drop_masks``); CUDA
    tensors launch the kernel."""
    name = "gemm"
    if epi not in EPILOGUES:
        raise ValueError(f"{name}: epi {epi!r} unknown")
    layout = "(K, N)" if w_in_out else "(N, K)"
    if epi not in ROUTE_EPILOGUES[bool(w_in_out)]:
        raise ValueError(f"{name}: epi {epi!r} does not run on the w "
                         f"{layout} route")
    out_f32 = out_dtype not in (None, a.dtype)
    res_f32 = res is not None and res.dtype == torch.float32 and \
        a.dtype != torch.float32
    fp32_epis = FP32_OUT_EPILOGUES[bool(w_in_out)]
    if out_f32 and (out_dtype != torch.float32 or epi not in fp32_epis):
        raise ValueError(f"{name}: an fp32 output takes the {fp32_epis} "
                         f"epilogues only on the w {layout} route (epi "
                         f"{epi!r}, out_dtype {out_dtype})")
    if res_f32 and (w_in_out or epi not in FP32_RES_EPILOGUES or (
            out_f32 and epi not in FP32_RES_OUT_EPILOGUES)):
        raise ValueError(f"{name}: an fp32 residual takes the "
                         f"{FP32_RES_EPILOGUES} epilogues with a bf16 "
                         f"output ({FP32_RES_OUT_EPILOGUES} also with an "
                         "fp32 output), on the w (N, K) route only (epi "
                         f"{epi!r}, w_in_out {w_in_out})")
    if not w_in_out and epi == "res_drop" and not (out_f32 or res_f32):
        raise ValueError(f"{name}: res_drop on the w (N, K) route takes an "
                         "fp32 output or an fp32 residual (the fuser's "
                         "training proj and fc2)")
    k_dim = 0 if w_in_out else 1
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[k_dim]:
        raise ValueError(f"{name}: needs a (M, K) and w {layout}, got "
                         f"{tuple(a.shape)} and {tuple(w.shape)}")
    M, K = a.shape
    N = w.shape[1 - k_dim]
    if min(M, N, K, tokens) < 1:
        raise ValueError(f"{name}: needs M, N, K and tokens >= 1 (M={M}, "
                         f"N={N}, K={K}, tokens={tokens})")
    if epi in _NEEDS_RES:
        if res is None:
            raise ValueError(f"{name}: epilogue {epi} needs res")
        check_shape(name, "res", res, (M, N))
    check_shape(name, "bias", bias, (N,))
    out_dt = torch.float32 if out_f32 else a.dtype
    if out is not None:
        check_shape(name, "out", out, (M, N))
        if out.dtype != out_dt or out.device != a.device:
            raise ValueError(f"{name}: out is {out.dtype} on {out.device}, "
                             f"expected {out_dt} on {a.device}")
    if a.device.type == "cpu":
        masks = None
        if epi == "res_drop":
            masks = drop_masks(M, N, tokens, seeds, block_idx, drop_rate,
                               dp_rate)
        return gemm_plain(a, w, epi, bias, res, masks, stash, out_dtype,
                          w_in_out, out)
    if a.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {a.device}")
    fp32 = {"res": res} if res_f32 else {}
    if out_f32 and out is not None:
        fp32["out"] = out
    check_kernel_operands(name, a, {"w": w, "bias": bias,
                                    **({} if res_f32 else {"res": res}),
                                    **({} if out_f32 or out is None
                                       else {"out": out})},
                          fp32=fp32)
    if out is None:
        out = torch.empty((M, N), dtype=out_dt, device=a.device)
    out2 = torch.empty((M, N), dtype=a.dtype, device=a.device) if (
        epi in _STASHES or (epi == "res_drop" and stash)) else None
    launch(name, "afft_gemm", EPILOGUES[epi], int(out_f32),
           int(not w_in_out), int(res_f32), ptr(a), ptr(w),
           ptr(bias), ptr(res), ptr(out), ptr(out2),
           *rate_arrays(seeds, block_idx, 0.0, drop_rate, dp_rate), M, N, K,
           tokens, device=a.device, pack=pack_scratch(a, M, N, K))
    LAUNCHES[name] += 1
    return out, out2


def pack_rows_plain(x):
    """x (rows, cols) copied into a (rows, pad8(cols)) buffer, its columns
    past cols zero; returns the (rows, cols) view."""
    rows, cols = x.shape
    out = torch.zeros((rows, pad8(cols)), dtype=x.dtype, device=x.device)
    return out[:, :cols].copy_(x)


def pack_rows(x):
    """x (rows, cols) in bf16 copied to rows of ``pad8(cols)`` columns, as
    the entries' products pack an operand whose rows are off TMA's 16-byte
    grid (``csrc/gemm_sm90.cuh`` ``pack_rows``, counted in
    ``_common.PACK_LAUNCHES`` there and here); returns the (rows, cols) view
    of the (rows, pad8(cols)) buffer, whose columns past cols are zero. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    name = "pack_rows"
    if x.dim() != 2 or min(x.shape) < 1:
        raise ValueError(f"{name}: needs x (rows, cols) with rows, cols >= "
                         f"1, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return pack_rows_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    check_kernel_operands(name, x, {})
    rows, cols = x.shape
    out = torch.empty((rows, pad8(cols)), dtype=x.dtype, device=x.device)
    launch(name, "afft_pack_rows", ptr(x), ptr(out), rows, cols,
           device=x.device)
    PACK_LAUNCHES[name] += 1
    return out[:, :cols]


def gemm_tn_plain(a, b):
    """a^T . b in fp32 on the exact products of the operands."""
    return a.float().t() @ b.float()


def gemm_tn(a, b, slices=None):
    """The weight gradient out (I, J) = a^T . b, fp32, for a (M, I) and b
    (M, J) in bf16, reduced over the M rows: on the card in ``slices``
    slices of M (default ``_common.tn_slices``, what the training entries
    take where they give the route scratch), their partial tiles summed in
    slice order. CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    name = "gemm_tn"
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"{name}: needs a (M, I) and b (M, J), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    M, I = a.shape
    J = b.shape[1]
    if min(M, I, J) < 1:
        raise ValueError(f"{name}: needs M, I and J >= 1 (M={M}, I={I}, "
                         f"J={J})")
    if slices is not None and slices < 1:
        raise ValueError(f"{name}: slices must be >= 1, got {slices}")
    if a.device.type == "cpu":
        return gemm_tn_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {a.device}")
    check_kernel_operands(name, a, {"b": b})
    if slices is None:
        slices = tn_slices(I, J, M, a.device)
    out = torch.empty((I, J), dtype=torch.float32, device=a.device)
    scratch = torch.empty((slices, I, J), dtype=torch.float32,
                          device=a.device) if slices > 1 else None
    launch(name, "afft_gemm_tn", ptr(a), ptr(b), ptr(out), ptr(scratch), I,
           J, M, slices, device=a.device,
           pack=pack_scratch(a, M, I, J))
    LAUNCHES[name] += 1
    return out
