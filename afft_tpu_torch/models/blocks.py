"""Eval-mode transformer primitives of the fuser: Attention, MLP, Block.

Port of afft_tpu/models/blocks.py (attention_apply, mlp_apply, block_apply;
reference models/transformerblock.py Attention, MLP, Block) as nn.Modules
with the reference's state-dict names (``norm1``, ``attn.qkv``,
``attn.proj``, ``norm2``, ``mlp.mlp.0``, ``mlp.mlp.2``). ``Block.forward``
is the module path, which returns the attention weights; the fuser stack
sends blocks whose weights are not asked for through ``ops.fused_block``
instead. Dropout and drop-path are training-time only and not ported yet.
"""

from __future__ import annotations

import torch.nn as nn

from . import layers as L


class Attention(nn.Module):
    """Fused-qkv self attention: softmax(q k^T * hd^-0.5 + mask) v."""

    def __init__(self, dim, num_heads, qkv_bias=False):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, mask=None):
        """x (B, N, C) -> (out (B, N, C), weights (B, H, N, N))."""
        B, N, C = x.shape
        hd = C // self.num_heads
        q, k, v = (self.qkv(x).reshape(B, N, 3, self.num_heads, hd)
                   .permute(2, 0, 3, 1, 4))
        attn = (q @ k.transpose(-2, -1)) * (hd ** -0.5)
        if mask is not None:
            attn = attn + mask
        attn = attn.softmax(dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(B, N, C)
        return self.proj(out), attn


class MLP(nn.Module):
    """Linear -> exact GELU -> Linear (``mlp.0`` / ``mlp.2``)."""

    def __init__(self, in_features, hidden_features):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(in_features, hidden_features),
                                 nn.GELU(),
                                 nn.Linear(hidden_features, in_features))

    def forward(self, x):
        return self.mlp(x)


class Block(nn.Module):
    """Pre-LN block: x + attn(LN(x)); x + mlp(LN(x))."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, qkv_bias=False,
                 norm_affine=True, norm_eps=1e-6):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=norm_eps,
                                  elementwise_affine=norm_affine)
        self.attn = Attention(dim, num_heads, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=norm_eps,
                                  elementwise_affine=norm_affine)
        self.mlp = MLP(dim, int(dim * mlp_ratio))

    def reset_parameters(self, gen):
        """Fuser init: N(0, 0.02) weights, zero biases, unit LayerNorms."""
        for lin in (self.attn.qkv, self.attn.proj, self.mlp.mlp[0],
                    self.mlp.mlp[2]):
            L.init_normal_linear(lin.weight, lin.bias, 0.02, gen)
        L.init_layer_norm(self.norm1)
        L.init_layer_norm(self.norm2)

    def forward(self, x, mask=None):
        """x (B, N, C) -> (x, attention weights (B, H, N, N))."""
        attn_out, weights = self.attn(self.norm1(x), mask)
        x = x + attn_out
        x = x + self.mlp(self.norm2(x))
        return x, weights
