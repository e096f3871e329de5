"""One GPT-2 layer on (B, T, C) as two halves: CUDA kernels and plain
versions.

Replaces ``afft_tpu/ops/pallas_gpt2.py:fused_gpt2_block`` (its
``_attn_half_kernel`` and ``_mlp_half_kernel``). The kernels
(``csrc/fused_gpt2.cu``) are short sequences of launches on the current
stream. ``params`` holds the layer's tensors under the reference's
state-dict names, relative to ``gpt_model.h.N`` (``ln_1.weight``,
``attn.c_attn.weight``, ``mlp.c_fc.weight``, ...). The weights are HF Conv1D
(in, out) and ``c_attn`` is packed [q | k | v], heads minor; the kernels read
that layout as it is.

Cast chain (``pallas_gpt2.py:100-151``): LN statistics, scores, softmax and
the residual adds are fp32; matmuls take the working dtype with fp32
accumulation; qkv, the softmax probabilities (before P . V), the attention
output, the half outputs and the gelu_new output are rounded to the working
dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._common import (DTYPE_CODES, LONG_LAUNCHES, add_bias, attention32,
                      check_heads, check_length, check_operands, check_shape,
                      launch, layer_norm32, mask_operand, matmul32,
                      pack_scratch, ptr)

LAUNCHES = {"gpt2_attn_half": 0, "gpt2_mlp_half": 0}


def gpt2_attn_half_plain(x, params, mask, *, num_heads: int,
                         eps: float = 1e-5):
    """x + c_proj(causal_attn(LN1(x))) in PyTorch ops, on any device."""
    B, T, C = x.shape
    dt = x.dtype
    x32 = x.reshape(B * T, C).float()
    xn = layer_norm32(x32, params.get("ln_1.weight"),
                      params.get("ln_1.bias"), eps).to(dt)
    qkv = add_bias(matmul32(xn, params["attn.c_attn.weight"], True),
                   params.get("attn.c_attn.bias")).to(dt)
    attn = attention32(qkv, mask, T, num_heads, round_p_to=dt).to(dt)
    proj = add_bias(matmul32(attn, params["attn.c_proj.weight"], True),
                    params.get("attn.c_proj.bias"))
    return (x32 + proj).to(dt).reshape(B, T, C)


def gpt2_mlp_half_plain(y, params, *, eps: float = 1e-5):
    """y + c_proj(gelu_new(c_fc(LN2(y)))) in PyTorch ops, on any device."""
    B, T, C = y.shape
    dt = y.dtype
    y32 = y.reshape(B * T, C).float()
    yn = layer_norm32(y32, params.get("ln_2.weight"),
                      params.get("ln_2.bias"), eps).to(dt)
    h = F.gelu(add_bias(matmul32(yn, params["mlp.c_fc.weight"], True),
                        params.get("mlp.c_fc.bias")),
               approximate="tanh").to(dt)
    h2 = add_bias(matmul32(h, params["mlp.c_proj.weight"], True),
                  params.get("mlp.c_proj.bias"))
    return (y32 + h2).to(dt).reshape(B, T, C)


def fused_gpt2_block_plain(x, params, mask, *, num_heads: int,
                           eps: float = 1e-5):
    y = gpt2_attn_half_plain(x, params, mask, num_heads=num_heads, eps=eps)
    return gpt2_mlp_half_plain(y, params, eps=eps)


def _check_x(name, x):
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (B, T, C), got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def gpt2_attn_half(x, params, mask, *, num_heads: int, eps: float = 1e-5):
    """Attention half of one GPT-2 layer; returns (B, T, C) in x.dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    name = "gpt2_attn_half"
    _check_x(name, x)
    if x.device.type == "cpu":
        return gpt2_attn_half_plain(x, params, mask, num_heads=num_heads,
                                    eps=eps)
    B, T, C = x.shape
    long = check_length(name, "gpt2", T, check_heads(name, C, num_heads))
    if mask is None:
        raise ValueError(f"{name}: the additive (T, T) mask is required")
    ops = {"ln_1.weight": params.get("ln_1.weight"),
           "ln_1.bias": params.get("ln_1.bias"),
           "attn.c_attn.weight": params["attn.c_attn.weight"],
           "attn.c_attn.bias": params.get("attn.c_attn.bias"),
           "attn.c_proj.weight": params["attn.c_proj.weight"],
           "attn.c_proj.bias": params.get("attn.c_proj.bias")}
    for key, shape in [("ln_1.weight", (C,)), ("ln_1.bias", (C,)),
                       ("attn.c_attn.weight", (C, 3 * C)),
                       ("attn.c_attn.bias", (3 * C,)),
                       ("attn.c_proj.weight", (C, C)),
                       ("attn.c_proj.bias", (C,))]:
        check_shape(name, key, ops[key], shape)
    if (ops["ln_1.weight"] is None) != (ops["ln_1.bias"] is None):
        raise ValueError(f"{name}: LayerNorm weight and bias go together")
    check_operands(name, x, ops)
    mask32 = mask_operand(name, mask, T, x.device)
    out = torch.empty_like(x)
    if B == 0:
        return out
    dt, dev = x.dtype, x.device
    tmp = torch.empty((B * T, C), dtype=dt, device=dev)
    qkv = torch.empty((B * T, 3 * C), dtype=dt, device=dev)
    launch(name, "afft_gpt2_attn_half",
           DTYPE_CODES[dt], ptr(x), ptr(ops["ln_1.weight"]),
           ptr(ops["ln_1.bias"]), ptr(ops["attn.c_attn.weight"]),
           ptr(ops["attn.c_attn.bias"]), ptr(ops["attn.c_proj.weight"]),
           ptr(ops["attn.c_proj.bias"]), ptr(mask32), ptr(tmp), ptr(qkv),
           ptr(out), B, T, C, num_heads, eps, device=dev,
           pack=pack_scratch(x, B * T, C, 3 * C))
    LAUNCHES[name] += 1
    LONG_LAUNCHES[name] += long
    return out


def gpt2_mlp_half(y, params, *, eps: float = 1e-5):
    """MLP half of one GPT-2 layer; returns (B, T, C) in y.dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    name = "gpt2_mlp_half"
    _check_x(name, y)
    if y.device.type == "cpu":
        return gpt2_mlp_half_plain(y, params, eps=eps)
    B, T, C = y.shape
    wfc = params["mlp.c_fc.weight"]
    hidden = wfc.shape[-1]
    ops = {"ln_2.weight": params.get("ln_2.weight"),
           "ln_2.bias": params.get("ln_2.bias"),
           "mlp.c_fc.weight": wfc,
           "mlp.c_fc.bias": params.get("mlp.c_fc.bias"),
           "mlp.c_proj.weight": params["mlp.c_proj.weight"],
           "mlp.c_proj.bias": params.get("mlp.c_proj.bias")}
    for key, shape in [("ln_2.weight", (C,)), ("ln_2.bias", (C,)),
                       ("mlp.c_fc.weight", (C, hidden)),
                       ("mlp.c_fc.bias", (hidden,)),
                       ("mlp.c_proj.weight", (hidden, C)),
                       ("mlp.c_proj.bias", (C,))]:
        check_shape(name, key, ops[key], shape)
    if (ops["ln_2.weight"] is None) != (ops["ln_2.bias"] is None):
        raise ValueError(f"{name}: LayerNorm weight and bias go together")
    check_operands(name, y, ops)
    out = torch.empty_like(y)
    if B * T == 0:
        return out
    dt, dev = y.dtype, y.device
    tmp = torch.empty((B * T, C), dtype=dt, device=dev)
    h = torch.empty((B * T, hidden), dtype=dt, device=dev)
    launch(name, "afft_gpt2_mlp_half",
           DTYPE_CODES[dt], ptr(y), ptr(ops["ln_2.weight"]),
           ptr(ops["ln_2.bias"]), ptr(wfc), ptr(ops["mlp.c_fc.bias"]),
           ptr(ops["mlp.c_proj.weight"]), ptr(ops["mlp.c_proj.bias"]),
           ptr(tmp), ptr(h), ptr(out), B * T, C, hidden, eps, device=dev,
           pack=pack_scratch(y, B * T, C, hidden))
    LAUNCHES[name] += 1
    return out


def fused_gpt2_block(x, params, mask, *, num_heads: int, eps: float = 1e-5):
    """One GPT-2 layer: the attention half, then the MLP half."""
    y = gpt2_attn_half(x, params, mask, num_heads=num_heads, eps=eps)
    return gpt2_mlp_half(y, params, eps=eps)
