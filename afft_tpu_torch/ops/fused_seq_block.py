"""The temporal fusers' blocks on (B, S, C) sequences: CUDA kernels and
plain versions.

Replaces ``afft_tpu/ops/pallas_seq_block.py``: ``fused_seq_block`` (one
pre-LN Block over S tokens, the T-SA-Fuser) and ``fused_decoder_block`` (one
DecoderBlock: causal self-attention, cross-attention into an equal-length
memory stream, MLP; the CA-Fuser). The kernels (``csrc/seq_block.cu``) are
sequences of launches on the current stream; the wrappers check the
operands, allocate outputs and scratch, and count their launches.

``params`` holds the block's tensors under the reference's state-dict names,
i.e. ``dict(block.named_parameters())``: ``norm1``, ``attn.qkv``,
``attn.proj``, ``norm2``, ``mlp.mlp.0``, ``mlp.mlp.2`` for a Block;
``norm_self``, ``attn.qkv``, ``attn.proj``, ``norm_q``, ``norm_kv``,
``cross_attn.w_q / w_k / w_v / proj``, ``norm_mlp``, ``mlp.mlp.0``,
``mlp.mlp.2`` for a DecoderBlock. LayerNorm affines and the qkv, w_q, w_k,
w_v biases are optional.

Cast chain (``pallas_seq_block.py:75-101``, ``:135-190``): LN statistics,
softmax and the residual stream are fp32 from the block's input to its last
add; LN outputs, q / k / v, the softmax probabilities (before P . V), the
attention outputs and the GELU output are rounded to the working dtype;
matmuls take the working dtype with fp32 accumulation; the memory stream is
normalised from its fp32 upcast.

Kernel limits: any B, 1 <= S <= 1024, H * hd == C with hd % 8 == 0,
hidden % 8 == 0, float32 or bfloat16, contiguous 16-byte aligned operands;
the mask is an additive (S, S) tensor or None and gates both attention
stages of the decoder block; mem has x's shape.
"""

from __future__ import annotations

import torch

from ._common import (DTYPE_CODES, add_bias, attention32, check_operands,
                      check_shape, launch, layer_norm32, mask_operand,
                      matmul32, ptr, ptr_array)
from .attention import MAX_KEYS, attention_plain
from .fused_block import block_operands, block_plain, mlp_plain

LAUNCHES = {"fused_seq_block": 0, "fused_decoder_block": 0}

MAX_TOKENS = MAX_KEYS

# the decoder kernel's parameter order (csrc/seq_block.cu, DecParam) with the
# shape of each tensor in terms of C and hidden
_DECODER_PARAMS = (
    ("norm_self.weight", ("C",)), ("norm_self.bias", ("C",)),
    ("attn.qkv.weight", ("3C", "C")), ("attn.qkv.bias", ("3C",)),
    ("attn.proj.weight", ("C", "C")), ("attn.proj.bias", ("C",)),
    ("norm_q.weight", ("C",)), ("norm_q.bias", ("C",)),
    ("norm_kv.weight", ("C",)), ("norm_kv.bias", ("C",)),
    ("cross_attn.w_q.weight", ("C", "C")), ("cross_attn.w_q.bias", ("C",)),
    ("cross_attn.w_k.weight", ("C", "C")), ("cross_attn.w_k.bias", ("C",)),
    ("cross_attn.w_v.weight", ("C", "C")), ("cross_attn.w_v.bias", ("C",)),
    ("cross_attn.proj.weight", ("C", "C")), ("cross_attn.proj.bias", ("C",)),
    ("norm_mlp.weight", ("C",)), ("norm_mlp.bias", ("C",)),
    ("mlp.mlp.0.weight", ("hidden", "C")), ("mlp.mlp.0.bias", ("hidden",)),
    ("mlp.mlp.2.weight", ("C", "hidden")), ("mlp.mlp.2.bias", ("C",)),
)
_REQUIRED = {k for k, _ in _DECODER_PARAMS
             if k.endswith(".weight") and not k.startswith("norm")}


def _check_x(name, x):
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (B, S, C), got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def _check_seq(name, S):
    if not 1 <= S <= MAX_TOKENS:
        raise ValueError(f"{name}: S={S} tokens, the kernel takes "
                         f"1..{MAX_TOKENS}")


def _scratch(x, hidden, n_tmp=1):
    B, S, C = x.shape
    M, dt, dev = B * S, x.dtype, x.device
    return ([torch.empty((M, C), dtype=dt, device=dev) for _ in range(n_tmp)]
            + [torch.empty((M, 3 * C), dtype=dt, device=dev),
               torch.empty((M, C), dtype=torch.float32, device=dev),
               torch.empty((M, hidden), dtype=dt, device=dev)])


# -- the T-SA-Fuser block ----------------------------------------------------

def fused_seq_block_plain(x, params, mask=None, *, num_heads: int,
                          eps: float = 1e-6):
    """The kernel's arithmetic in PyTorch ops, on any device."""
    return block_plain(x, params, mask, num_heads, eps, round_p=True)


def fused_seq_block(x, params, mask=None, *, num_heads: int,
                    eps: float = 1e-6):
    """Run one pre-LN Block over (B, S, C); returns (B, S, C) in x.dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    name = "fused_seq_block"
    _check_x(name, x)
    if x.device.type == "cpu":
        return fused_seq_block_plain(x, params, mask, num_heads=num_heads,
                                     eps=eps)
    B, S, C = x.shape
    _check_seq(name, S)
    tensors, hidden = block_operands(name, x, params, num_heads)
    mask32 = mask_operand(name, mask, S, x.device)
    out = torch.empty_like(x)
    if B == 0:
        return out
    tmp, qkv, y, h1 = _scratch(x, hidden)
    launch(name, "afft_fused_seq_block", DTYPE_CODES[x.dtype], ptr(x),
           ptr_array(tensors), ptr(mask32), ptr(tmp), ptr(qkv), ptr(y),
           ptr(h1), ptr(out), B, S, C, num_heads, hidden, eps,
           device=x.device)
    LAUNCHES[name] += 1
    return out


# -- the CA-Fuser decoder block ----------------------------------------------

def fused_decoder_block_plain(x, mem, params, mask=None, *, num_heads: int,
                              eps: float = 1e-6):
    """The kernel's arithmetic in PyTorch ops, on any device."""
    B, S, C = x.shape
    dt = x.dtype
    g = params.get
    hd = C // num_heads

    def linear(a, key):
        return add_bias(matmul32(a, params[f"{key}.weight"], False),
                        g(f"{key}.bias"))

    x32 = x.reshape(B * S, C).float()
    mem32 = mem.reshape(B * S, C).float()
    xn = layer_norm32(x32, g("norm_self.weight"), g("norm_self.bias"),
                      eps).to(dt)
    qkv = linear(xn, "attn.qkv").to(dt)
    attn = attention32(qkv, mask, S, num_heads, round_p_to=dt).to(dt)
    x1 = x32 + linear(attn, "attn.proj")

    qn = layer_norm32(x1, g("norm_q.weight"), g("norm_q.bias"), eps).to(dt)
    kn = layer_norm32(mem32, g("norm_kv.weight"), g("norm_kv.bias"),
                      eps).to(dt)
    q, k, v = (linear(a, f"cross_attn.{key}").to(dt)
               .reshape(B, S, num_heads, hd)
               for a, key in ((qn, "w_q"), (kn, "w_k"), (kn, "w_v")))
    cross, _ = attention_plain(q, k, v, mask)
    x2 = x1 + linear(cross.reshape(B * S, C), "cross_attn.proj")

    return mlp_plain(x2, g("norm_mlp.weight"), g("norm_mlp.bias"),
                     params["mlp.mlp.0.weight"], g("mlp.mlp.0.bias"),
                     params["mlp.mlp.2.weight"], g("mlp.mlp.2.bias"), eps,
                     dt).reshape(B, S, C)


def fused_decoder_block(x, mem, params, mask=None, *, num_heads: int,
                        eps: float = 1e-6):
    """Run one DecoderBlock over x (B, S, C) with the memory stream mem
    (B, S, C); returns (B, S, C) in x.dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    name = "fused_decoder_block"
    _check_x(name, x)
    if tuple(mem.shape) != tuple(x.shape):
        raise ValueError(f"{name}: mem has shape {tuple(mem.shape)}, x "
                         f"{tuple(x.shape)}; the streams must share a shape")
    if x.device.type == "cpu":
        return fused_decoder_block_plain(x, mem, params, mask,
                                         num_heads=num_heads, eps=eps)
    B, S, C = x.shape
    _check_seq(name, S)
    missing = sorted(_REQUIRED - set(params))
    if missing:
        raise KeyError(f"{name}: params lack {missing}")
    hidden = params["mlp.mlp.0.weight"].shape[0]
    hd = C // num_heads
    if hd * num_heads != C or hd % 8 or hidden % 8:
        raise ValueError(f"{name}: needs H*hd == C with hd % 8 == 0 and "
                         f"hidden % 8 == 0 (C={C}, H={num_heads}, "
                         f"hidden={hidden})")
    dims = {"C": C, "3C": 3 * C, "hidden": hidden}
    operands = {key: params.get(key) for key, _ in _DECODER_PARAMS}
    for key, shape in _DECODER_PARAMS:
        check_shape(name, key, operands[key],
                    tuple(dims[d] for d in shape))
    for norm in ("norm_self", "norm_q", "norm_kv", "norm_mlp"):
        if (operands[f"{norm}.weight"] is None) != \
                (operands[f"{norm}.bias"] is None):
            raise ValueError(f"{name}: LayerNorm weight and bias go "
                             "together")
    check_operands(name, x, {"mem": mem, **operands})
    mask32 = mask_operand(name, mask, S, x.device)
    out = torch.empty_like(x)
    if B == 0:
        return out
    tmp, tmp2, qkv, y, h1 = _scratch(x, hidden, n_tmp=2)
    launch(name, "afft_fused_decoder_block", DTYPE_CODES[x.dtype], ptr(x),
           ptr(mem), ptr_array(list(operands.values())), ptr(mask32),
           ptr(tmp), ptr(tmp2), ptr(qkv), ptr(y), ptr(h1), ptr(out), B, S, C,
           num_heads, hidden, eps, device=x.device)
    LAUNCHES[name] += 1
    return out
