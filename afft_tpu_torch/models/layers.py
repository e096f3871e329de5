"""Primitives shared by the port's modules: the additive attention masks
and seeded initialisers.

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


def neg_inf_causal_mask(sz: int, dtype=torch.float32, device=None):
    """Additive causal mask: 0 on/below the diagonal, -inf above."""
    return torch.triu(torch.full((sz, sz), float("-inf"), dtype=dtype,
                                 device=device), diagonal=1)


def cross_attention_diag_mask(sz: int, dtype=torch.float32, device=None):
    """-inf on the diagonal (each modality masks itself), 0 elsewhere."""
    eye = torch.eye(sz, dtype=torch.bool, device=device)
    return torch.zeros((sz, sz), dtype=dtype, device=device).masked_fill(
        eye, float("-inf"))


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
