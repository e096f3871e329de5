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
``DecoderBlock.forward`` returns no weights; in eval mode it is
``ops.fused_decoder_block`` on the module's own parameters: one arithmetic
for the module and the CA-Fuser. In training mode ``Block.forward`` is the
plain path of ``block_apply(train=True)`` (dropout on the attention weights,
on the proj and MLP outputs, drop-path on both branches, masks drawn by
PyTorch from the step's ``RngStream``); the per-timestep fusers take it when
attention weights are asked for, and otherwise train through
``ops.fused_block_train``; the T-SA-Fuser's blocks (sequences longer than
that kernel takes) take it without weights, their attention through
``layers.attention`` (the kernel of row 4 under autograd where no
attention dropout is in force). ``DecoderBlock.forward`` in training mode is
``decoder_block_apply(train=True)`` (afft_tpu/models/blocks.py:139-158):
self-attention, cross-attention into the memory stream and the MLP, each
with its proj / MLP dropout and drop-path, dropout on both attentions'
weights, under autograd.
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
                rng=None, need_weights=True, impl="kernel"):
        """x (B, N, C) -> (out (B, N, C), weights (B, H, N, N) or None); in
        training mode the weights are returned after their dropout."""
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads,
                                  C // self.num_heads)
        out, attn = L.attention(
            qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], mask,
            attn_drop=attn_drop, train=self.training, rng=rng,
            return_weights=need_weights, impl=impl)
        out = self.proj(out.reshape(B, N, C))
        return L.dropout(out, proj_drop, self.training, rng), attn


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

    def forward(self, x, mask=None, *, rng=None, need_weights=True,
                impl="kernel"):
        """x (B, N, C) -> (x, attention weights (B, H, N, N) or None). The
        single MLP dropout follows fc2 (reference
        models/transformerblock.py:84-89)."""
        train = self.training
        attn_out, weights = self.attn(self.norm1(x), mask,
                                      attn_drop=self.attn_drop,
                                      proj_drop=self.drop, rng=rng,
                                      need_weights=need_weights, impl=impl)
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
    reference does, and another memory width or length raises there. The
    training path (``forward`` in training mode) takes any memory stream."""

    def __init__(self, dim, mem_dim=None, num_heads=4, mlp_ratio=4.0,
                 qkv_bias=False, norm_affine=True, norm_eps=1e-6, drop=0.0,
                 attn_drop=0.0, drop_path=0.0):
        super().__init__()
        self.num_heads = num_heads
        self.drop, self.attn_drop, self.drop_path = drop, attn_drop, drop_path
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

    def forward(self, x, mem, mask=None, *, impl="kernel", rng=None):
        """x, mem (B, N, C) -> x (B, N, C); ``impl="plain"`` runs the
        kernels' plain versions on any device (the comparison on the
        card). In training mode: the plain path under autograd, its
        attentions through ``layers.attention``."""
        if self.training:
            return self._forward_train(x, mem, mask, impl, rng)
        block_fn = (FS.fused_decoder_block if impl == "kernel"
                    else FS.fused_decoder_block_plain)
        return block_fn(x, mem, dict(self.named_parameters()), mask,
                        num_heads=self.num_heads, eps=self.norm_eps)

    def _forward_train(self, x, mem, mask, impl, rng):
        attn_out, _ = self.attn(self.norm_self(x), mask,
                                attn_drop=self.attn_drop,
                                proj_drop=self.drop, rng=rng,
                                need_weights=False, impl=impl)
        x = x + L.drop_path(attn_out, self.drop_path, True, rng)
        cross_out = self.cross_attn(self.norm_q(x), self.norm_kv(mem), mask,
                                    attn_drop=self.attn_drop,
                                    proj_drop=self.drop, rng=rng, impl=impl)
        x = x + L.drop_path(cross_out, self.drop_path, True, rng)
        mlp_out = L.dropout(self.mlp(self.norm_mlp(x)), self.drop, True, rng)
        return x + L.drop_path(mlp_out, self.drop_path, True, rng)
