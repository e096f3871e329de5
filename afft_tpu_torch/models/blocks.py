"""Transformer primitives of the fusers: Attention, MLP, Block,
DecoderBlock.

Port of afft_tpu/models/blocks.py (attention_apply, mlp_apply, block_apply,
decoder_block_init / decoder_block_apply; reference
models/transformerblock.py Attention, MLP, Block, DecoderBlock) as
nn.Modules with the reference's state-dict names (``norm1``, ``attn.qkv``,
``attn.proj``, ``norm2``, ``mlp.mlp.0``, ``mlp.mlp.2``; ``norm_self``,
``norm_q``, ``norm_kv``, ``cross_attn.w_q``, ``norm_mlp`` for the decoder
block). ``Block.forward`` is the module path, which also returns the
attention weights; when none are asked for, the fusers send their blocks
through ``ops.fused_block`` and ``ops.fused_seq_block`` instead.
``DecoderBlock.forward`` returns no weights and is ``ops.fused_decoder_block``
on the module's own parameters: one arithmetic for the module and the
CA-Fuser. In training mode ``Block.forward`` is the plain path of
``block_apply(train=True)`` (dropout on the attention weights, on the proj and
MLP outputs, drop-path on both branches, masks drawn by PyTorch from the
step's ``RngStream``); the fusers take it when attention weights are asked
for, and otherwise train through ``ops.fused_block_train``. The DecoderBlock
has no training path (no dropout, no backward kernel): the CA-Fuser raises
in training mode.
"""

from __future__ import annotations

import torch.nn as nn

from . import layers as L
from ..ops import fused_seq_block as FS


class Attention(nn.Module):
    """Fused-qkv self attention: softmax(q k^T * hd^-0.5 + mask) v."""

    def __init__(self, dim, num_heads, qkv_bias=False):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, mask=None, *, attn_drop=0.0, proj_drop=0.0,
                rng=None):
        """x (B, N, C) -> (out (B, N, C), weights (B, H, N, N)); in training
        mode the weights are returned after their dropout."""
        B, N, C = x.shape
        hd = C // self.num_heads
        q, k, v = (self.qkv(x).reshape(B, N, 3, self.num_heads, hd)
                   .permute(2, 0, 3, 1, 4))
        attn = (q @ k.transpose(-2, -1)) * (hd ** -0.5)
        if mask is not None:
            attn = attn + mask
        attn = L.dropout(attn.softmax(dim=-1), attn_drop, self.training, rng)
        out = (attn.to(v.dtype) @ v).transpose(1, 2).reshape(B, N, C)
        return L.dropout(self.proj(out), proj_drop, self.training, rng), attn


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
                 norm_affine=True, norm_eps=1e-6, drop=0.0, attn_drop=0.0,
                 drop_path=0.0):
        super().__init__()
        self.drop, self.attn_drop, self.drop_path = drop, attn_drop, drop_path
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

    def forward(self, x, mask=None, *, rng=None):
        """x (B, N, C) -> (x, attention weights (B, H, N, N)). The single
        MLP dropout follows fc2 (reference models/transformerblock.py
        :84-89)."""
        train = self.training
        attn_out, weights = self.attn(self.norm1(x), mask,
                                      attn_drop=self.attn_drop,
                                      proj_drop=self.drop, rng=rng)
        x = x + L.drop_path(attn_out, self.drop_path, train, rng)
        mlp_out = L.dropout(self.mlp(self.norm2(x)), self.drop, train, rng)
        x = x + L.drop_path(mlp_out, self.drop_path, train, rng)
        return x, weights


class DecoderBlock(nn.Module):
    """Self-attention, cross-attention into a memory stream, MLP; the same
    mask gates both attention stages (reference
    models/transformerblock.py:157-162). The forward is
    ``ops.fused_decoder_block``, which takes a memory stream of x's own
    shape (every CA-Fuser's); ``mem_dim`` sizes the parameters as the
    reference does, and another memory width or length raises there."""

    def __init__(self, dim, mem_dim=None, num_heads=4, mlp_ratio=4.0,
                 qkv_bias=False, norm_affine=True, norm_eps=1e-6):
        super().__init__()
        self.num_heads = num_heads
        self.norm_eps = norm_eps

        def norm(width):
            return nn.LayerNorm(width, eps=norm_eps,
                                elementwise_affine=norm_affine)
        self.norm_self = norm(dim)
        self.attn = Attention(dim, num_heads, qkv_bias)
        self.norm_q = norm(dim)
        self.norm_kv = norm(mem_dim or dim)
        self.cross_attn = L.CrossAttention(dim, num_heads, mem_dim, qkv_bias)
        self.norm_mlp = norm(dim)
        self.mlp = MLP(dim, int(dim * mlp_ratio))

    def reset_parameters(self, gen):
        """Fuser init: N(0, 0.02) weights, zero biases, unit LayerNorms."""
        for lin in (self.attn.qkv, self.attn.proj):
            L.init_normal_linear(lin.weight, lin.bias, 0.02, gen)
        self.cross_attn.reset_parameters(gen)
        for lin in (self.mlp.mlp[0], self.mlp.mlp[2]):
            L.init_normal_linear(lin.weight, lin.bias, 0.02, gen)
        for norm in (self.norm_self, self.norm_q, self.norm_kv,
                     self.norm_mlp):
            L.init_layer_norm(norm)

    def forward(self, x, mem, mask=None, *, impl="kernel"):
        """x, mem (B, N, C) -> x (B, N, C); ``impl="plain"`` runs the
        kernel's plain version on any device (the comparison on the card)."""
        block_fn = (FS.fused_decoder_block if impl == "kernel"
                    else FS.fused_decoder_block_plain)
        return block_fn(x, mem, dict(self.named_parameters()), mask,
                        num_heads=self.num_heads, eps=self.norm_eps)
