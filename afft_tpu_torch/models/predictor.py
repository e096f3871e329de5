"""Causal future predictor: a GPT-2 over feature embeddings (no wte).

Port of afft_tpu/models/predictor.py ``BaseFuturePredictor`` (reference
models/future_prediction.py:354-415, an HF ``GPT2Model`` fed with
``inputs_embeds``): learned position embeddings, pre-LN blocks (eps 1e-5),
packed qkv with bias, causal attention, gelu_new MLP, final ``ln_f``.
State-dict names are HF's under ``gpt_model``: ``h.N.ln_1``,
``h.N.attn.c_attn`` (Conv1D (in, 3C), packed [q | k | v]), ``h.N.attn.c_proj``,
``h.N.ln_2``, ``h.N.mlp.c_fc``, ``h.N.mlp.c_proj``, ``wpe``, ``ln_f``.

Each layer runs as ``ops.fused_gpt2.fused_gpt2_block`` (two CUDA kernels on
a CUDA tensor, their plain versions on a CPU tensor). This slice serves the
single causal pass, ``fp_output_len == 1``; the multi-step KV-cache rollout
waits for the port of the ``pallas_attn`` kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from . import layers as L
from .fusion import check_impl
from ..ops import fused_gpt2 as FG

LN_EPS = 1e-5


class Conv1D(nn.Module):
    """HF GPT-2 Conv1D parameters, y = x @ weight + bias with the weight
    stored (in, out); the GPT-2 kernels read them as they are."""

    def __init__(self, n_out, n_in):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n_in, n_out))
        self.bias = nn.Parameter(torch.zeros(n_out))


class GPT2Attention(nn.Module):
    def __init__(self, n_embd):
        super().__init__()
        self.c_attn = Conv1D(3 * n_embd, n_embd)
        self.c_proj = Conv1D(n_embd, n_embd)


class GPT2MLP(nn.Module):
    def __init__(self, n_embd, n_inner):
        super().__init__()
        self.c_fc = Conv1D(n_inner, n_embd)
        self.c_proj = Conv1D(n_embd, n_inner)


class GPT2Block(nn.Module):
    def __init__(self, n_embd, n_inner):
        super().__init__()
        self.ln_1 = nn.LayerNorm(n_embd, eps=LN_EPS)
        self.attn = GPT2Attention(n_embd)
        self.ln_2 = nn.LayerNorm(n_embd, eps=LN_EPS)
        self.mlp = GPT2MLP(n_embd, n_inner)


class GPT2Model(nn.Module):
    def __init__(self, n_embd, n_layer, n_inner, n_positions):
        super().__init__()
        self.wpe = nn.Embedding(n_positions, n_embd)
        self.h = nn.ModuleList([GPT2Block(n_embd, n_inner)
                                for _ in range(n_layer)])
        self.ln_f = nn.LayerNorm(n_embd, eps=LN_EPS)


class BaseFuturePredictor(nn.Module):
    def __init__(self, in_features, inter_dim=2048, n_layer=6, n_head=4,
                 embd_pdrop=0.1, resid_pdrop=0.1, attn_pdrop=0.1,
                 output_attentions=False, dimension_mapping=False,
                 n_positions=1024, **_ignored):
        super().__init__()
        # dropout rates are training-time only
        del embd_pdrop, resid_pdrop, attn_pdrop
        if dimension_mapping:
            raise ValueError("dimension mapping inside the predictor is "
                             "deprecated (reference "
                             "models/future_prediction.py:366)")
        if not isinstance(output_attentions, bool):
            raise TypeError(
                f"output_attentions must be a bool, got "
                f"{output_attentions!r} — check "
                f"model.common.fp_output_attentions in the config")
        if output_attentions:
            raise NotImplementedError(
                "output_attentions=True is not ported yet (ROADMAP.md "
                "§A.3: the attention-returning predictor path)")
        del in_features  # the predictor runs at inter_dim (no mapping)
        self.n_layer = n_layer
        self.n_head = n_head
        self.n_inner = 4 * inter_dim
        self.gpt_model = GPT2Model(inter_dim, n_layer, self.n_inner,
                                   n_positions)

    def reset_parameters(self, gen):
        """GPT-2 init: N(0, 0.02), residual projections N(0, 0.02 /
        sqrt(2 n_layer)), zero biases, unit LayerNorms."""
        std = 0.02
        proj_std = std / math.sqrt(2 * self.n_layer)
        for blk in self.gpt_model.h:
            for conv, s in ((blk.attn.c_attn, std),
                            (blk.attn.c_proj, proj_std),
                            (blk.mlp.c_fc, std), (blk.mlp.c_proj, proj_std)):
                L.init_normal_linear(conv.weight, conv.bias, s, gen)
            L.init_layer_norm(blk.ln_1)
            L.init_layer_norm(blk.ln_2)
        L.normal_(self.gpt_model.wpe.weight, std, gen)
        L.init_layer_norm(self.gpt_model.ln_f)

    def forward(self, feats, output_len: int = 1, *, impl="kernel"):
        """feats (B, T, C) -> (hidden (B, T, C), extra endpoints {})."""
        if output_len != 1:
            raise NotImplementedError(
                f"fp_output_len={output_len}: the multi-step KV-cache "
                "rollout is not ported yet (ROADMAP.md §B.5, pallas_attn "
                "with the KV rollout)")
        check_impl(impl)
        T = feats.shape[1]
        x = feats + self.gpt_model.wpe.weight[:T]
        mask = L.neg_inf_causal_mask(T, device=x.device)
        layer_fn = (FG.fused_gpt2_block if impl == "kernel"
                    else FG.fused_gpt2_block_plain)
        for blk in self.gpt_model.h:
            x = layer_fn(x, dict(blk.named_parameters()), mask,
                         num_heads=self.n_head, eps=LN_EPS)
        return self.gpt_model.ln_f(x), {}
