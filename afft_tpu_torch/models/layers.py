"""Primitives shared by the port's modules: the additive attention masks,
the cross-attention layer and seeded initialisers.

The modules build their LayerNorms with an explicit eps (1e-6 in the fuser,
1e-5 in the GPT-2 predictor); the GELUs (exact erf in the fuser MLP, tanh
"gelu_new" in GPT-2) are applied in ``ops``. Initialisers draw from an
explicit ``torch.Generator`` with the same distributions as
afft_tpu/models/layers.py (not the same numbers).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..ops.attention import multihead_attention


def neg_inf_causal_mask(sz: int, dtype=torch.float32, device=None):
    """Additive causal mask: 0 on/below the diagonal, -inf above."""
    return torch.triu(torch.full((sz, sz), float("-inf"), dtype=dtype,
                                 device=device), diagonal=1)


def cross_attention_diag_mask(sz: int, dtype=torch.float32, device=None):
    """-inf on the diagonal (each modality masks itself), 0 elsewhere."""
    eye = torch.eye(sz, dtype=torch.bool, device=device)
    return torch.zeros((sz, sz), dtype=dtype, device=device).masked_fill(
        eye, float("-inf"))


class CrossAttention(nn.Module):
    """Attention of x (B, N, C) into a memory stream mem (B, M, C) through
    separate projections ``w_q``, ``w_k``, ``w_v`` and ``proj`` (port of
    afft_tpu/models/blocks.py cross_attention_init / cross_attention_apply;
    reference models/transformerblock.py CrossAttention). The attention
    itself is ``ops.attention.multihead_attention``: the CUDA kernel on
    CUDA tensors, its plain version on CPU tensors. Eval mode only.

    This is the general layer: mem may have another length and width than
    x. The DecoderBlock holds one for its parameters and runs
    ``ops.fused_decoder_block`` on them, so no served model calls this
    forward; it stands for callers with unequal streams."""

    def __init__(self, dim, num_heads, mem_dim=None, qkv_bias=False):
        super().__init__()
        self.num_heads = num_heads
        mem_dim = mem_dim or dim
        self.w_q = nn.Linear(dim, dim, bias=qkv_bias)
        self.w_k = nn.Linear(mem_dim, dim, bias=qkv_bias)
        self.w_v = nn.Linear(mem_dim, dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def reset_parameters(self, gen):
        for lin in (self.w_q, self.w_k, self.w_v, self.proj):
            init_normal_linear(lin.weight, lin.bias, 0.02, gen)

    def forward(self, x, mem, mask=None):
        B, N, C = x.shape
        M = mem.shape[1]
        hd = C // self.num_heads
        q = self.w_q(x).reshape(B, N, self.num_heads, hd)
        k = self.w_k(mem).reshape(B, M, self.num_heads, hd)
        v = self.w_v(mem).reshape(B, M, self.num_heads, hd)
        out, _ = multihead_attention(q, k, v, mask)
        return self.proj(out.reshape(B, N, C))


# -- seeded initialisers ------------------------------------------------------

@torch.no_grad()
def normal_(t: torch.Tensor, std: float, gen: torch.Generator):
    """N(0, std): timm's trunc_normal_(std=.02) truncates at +-2, i.e. at
    +-100 sigma, so the plain normal is the same distribution in practice."""
    return t.copy_(torch.randn(t.shape, generator=gen, device=t.device,
                               dtype=torch.float32) * std)


@torch.no_grad()
def uniform_(t: torch.Tensor, bound: float, gen: torch.Generator):
    return t.copy_((torch.rand(t.shape, generator=gen, device=t.device,
                               dtype=torch.float32) * 2 - 1) * bound)


@torch.no_grad()
def init_torch_linear(lin: nn.Linear, gen: torch.Generator):
    """torch.nn.Linear default: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(lin.in_features)
    uniform_(lin.weight, bound, gen)
    if lin.bias is not None:
        uniform_(lin.bias, bound, gen)


@torch.no_grad()
def init_normal_linear(weight, bias, std: float, gen: torch.Generator):
    """Fuser and GPT-2 init: N(0, std) weight, zero bias."""
    normal_(weight, std, gen)
    if bias is not None:
        bias.zero_()


@torch.no_grad()
def init_layer_norm(norm: nn.LayerNorm):
    if norm.weight is not None:
        norm.weight.fill_(1.0)
        norm.bias.zero_()
