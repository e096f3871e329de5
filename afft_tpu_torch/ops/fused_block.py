"""One pre-LN fuser block on (R, N, C) tokens: CUDA kernel and plain version.

Replaces ``afft_tpu/ops/pallas_block.py:fused_block``. The kernel
(``csrc/fused_block.cu``) is a sequence of launches on the current stream;
this wrapper checks the operands, allocates the outputs and scratch, and
counts its launches. ``params`` holds the block's tensors under the
reference's state-dict names (``norm1.weight``, ``attn.qkv.weight``,
``mlp.mlp.0.weight``, ...), i.e. ``dict(block.named_parameters())``;
LayerNorm affines and the qkv bias are optional.

Cast chain (``pallas_block.py:141-188``): LN statistics, softmax, the
probability . v product and the residual stream ``y`` are fp32; matmuls take
the working dtype with fp32 accumulation; qkv, the attention output, the
LN outputs and the GELU output are rounded to the working dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._common import (DTYPE_CODES, LONG_LAUNCHES, SHORT_LENGTH, add_bias,
                      attention32, check_heads, check_length, check_operands,
                      check_shape, launch, layer_norm32, mask_operand,
                      matmul32, pack_scratch, ptr)

LAUNCHES = {"fused_block": 0}

# The fusers' dispatch (models/fusion.py), as the JAX package's
# (pallas_block.py supported): rows of up to 8 tokens go through this block,
# longer sequences through fused_seq_block. The kernel itself takes any N.
MAX_TOKENS = SHORT_LENGTH["fuser"]


def _unpack(params):
    g = params.get
    return (g("norm1.weight"), g("norm1.bias"), params["attn.qkv.weight"],
            g("attn.qkv.bias"), params["attn.proj.weight"],
            g("attn.proj.bias"), g("norm2.weight"), g("norm2.bias"),
            params["mlp.mlp.0.weight"], g("mlp.mlp.0.bias"),
            params["mlp.mlp.2.weight"], g("mlp.mlp.2.bias"))


def block_plain(x, params, mask, num_heads, eps, round_p):
    """A pre-LN block on (n, S, C) in PyTorch ops; ``round_p`` rounds the
    softmax probabilities to x.dtype before P . V (the sequence-block
    kernel does, this module's kernel keeps them fp32)."""
    R, N, C = x.shape
    dt = x.dtype
    (ln1g, ln1b, wqkv, bqkv, wproj, bproj, ln2g, ln2b, wfc1, bfc1, wfc2,
     bfc2) = _unpack(params)
    x32 = x.reshape(R * N, C).float()
    xn = layer_norm32(x32, ln1g, ln1b, eps).to(dt)
    qkv = add_bias(matmul32(xn, wqkv, False), bqkv).to(dt)
    attn = attention32(qkv, mask, N, num_heads,
                       round_p_to=dt if round_p else None).to(dt)
    y = x32 + add_bias(matmul32(attn, wproj, False), bproj)
    return mlp_plain(y, ln2g, ln2b, wfc1, bfc1, wfc2, bfc2, eps,
                     dt).reshape(R, N, C)


def mlp_plain(y, lng, lnb, wfc1, bfc1, wfc2, bfc2, eps, dt):
    """y + fc2(gelu(fc1(LN(y)))) on the fp32 residual stream y (M, C);
    returns (M, C) in ``dt``."""
    yn = layer_norm32(y, lng, lnb, eps).to(dt)
    h1 = F.gelu(add_bias(matmul32(yn, wfc1, False), bfc1)).to(dt)
    return (y + add_bias(matmul32(h1, wfc2, False), bfc2)).to(dt)


def fused_block_plain(x, params, mask=None, *, num_heads: int,
                      eps: float = 1e-6):
    """The kernel's arithmetic in PyTorch ops, on any device."""
    return block_plain(x, params, mask, num_heads, eps, round_p=False)


def block_operands(name, x, params, num_heads, differentiable=False):
    """Check a block's tensors against x (n, S, C) for a CUDA launch; returns
    (the twelve tensors in the kernels' order, hidden)."""
    C = x.shape[-1]
    tensors = _unpack(params)
    (ln1g, ln1b, wqkv, bqkv, wproj, bproj, ln2g, ln2b, wfc1, bfc1, wfc2,
     bfc2) = tensors
    hidden = wfc1.shape[0]
    check_heads(name, C, num_heads)
    keys = ("norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias",
            "attn.proj.weight", "attn.proj.bias", "norm2.weight",
            "norm2.bias", "mlp.mlp.0.weight", "mlp.mlp.0.bias",
            "mlp.mlp.2.weight", "mlp.mlp.2.bias")
    shapes = ((C,), (C,), (3 * C, C), (3 * C,), (C, C), (C,), (C,), (C,),
              (hidden, C), (hidden,), (C, hidden), (C,))
    for key, t, shape in zip(keys, tensors, shapes):
        check_shape(name, key, t, shape)
    if (ln1g is None) != (ln1b is None) or (ln2g is None) != (ln2b is None):
        raise ValueError(f"{name}: LayerNorm weight and bias go together")
    check_operands(name, x, dict(zip(keys, tensors)), differentiable)
    return tensors, hidden


def fused_block(x, params, mask=None, *, num_heads: int, eps: float = 1e-6):
    """Run one fuser block; returns (R, N, C) in x.dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    name = "fused_block"
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (R, N, C), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return fused_block_plain(x, params, mask, num_heads=num_heads,
                                 eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    R, N, C = x.shape
    long = check_length(name, "fuser", N, check_heads(name, C, num_heads))
    tensors, hidden = block_operands(name, x, params, num_heads)
    mask32 = mask_operand(name, mask, N, x.device)
    out = torch.empty_like(x)
    if R == 0:
        return out
    M = R * N
    dt, dev = x.dtype, x.device
    tmp = torch.empty((M, C), dtype=dt, device=dev)
    qkv = torch.empty((M, 3 * C), dtype=dt, device=dev)
    y = torch.empty((M, C), dtype=torch.float32, device=dev)
    h1 = torch.empty((M, hidden), dtype=dt, device=dev)
    launch(name, "afft_fused_block", DTYPE_CODES[dt], ptr(x),
           *[ptr(t) for t in tensors], ptr(mask32), ptr(tmp), ptr(qkv),
           ptr(y), ptr(h1), ptr(out), R, N, C, num_heads, hidden, eps,
           device=dev, pack=pack_scratch(x, M, C, 3 * C, hidden))
    LAUNCHES[name] += 1
    LONG_LAUNCHES[name] += long
    return out
