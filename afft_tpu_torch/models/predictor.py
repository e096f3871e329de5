"""Causal future predictor: a GPT-2 over feature embeddings (no wte).

Port of afft_tpu/models/predictor.py ``BaseFuturePredictor`` (reference
models/future_prediction.py:354-415, an HF ``GPT2Model`` fed with
``inputs_embeds``): learned position embeddings, pre-LN blocks (eps 1e-5),
packed qkv with bias, causal attention, gelu_new MLP, final ``ln_f``.
State-dict names are HF's under ``gpt_model``: ``h.N.ln_1``,
``h.N.attn.c_attn`` (Conv1D (in, 3C), packed [q | k | v]), ``h.N.attn.c_proj``,
``h.N.ln_2``, ``h.N.mlp.c_fc``, ``h.N.mlp.c_proj``, ``wpe``, ``ln_f``.

Three paths, as in the JAX package:
- the single causal pass (``output_len == 1``): each layer runs as
  ``ops.fused_gpt2.fused_gpt2_block`` (two CUDA kernels on a CUDA tensor,
  their plain versions on a CPU tensor);
- the multi-step rollout in eval mode (``output_len > 1``): a KV cache, one
  prefill over the T input tokens and ``output_len - 1`` single-token decode
  steps, each step fed the last hidden state after ``ln_f``. The cached
  block is plain ``LayerNorm`` / ``addmm`` calls around
  ``ops.attention.fused_attention`` (the CUDA kernel on CUDA tensors);
- ``output_attentions=True``: the full re-run of every step on the plain
  path, which returns the attention weights as ``gpt2_att_{step}``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import layers as L
from .fusion import check_impl
from ..ops import attention as FA
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
        del in_features  # the predictor runs at inter_dim (no mapping)
        self.output_attentions = output_attentions
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

    @staticmethod
    def _conv1d(conv, x):
        """x (B, S, in) @ weight (in, out) + bias."""
        return torch.addmm(conv.bias, x.reshape(-1, x.shape[-1]),
                           conv.weight).reshape(*x.shape[:-1], -1)

    def _mlp(self, blk, x):
        h = F.gelu(self._conv1d(blk.mlp.c_fc, blk.ln_2(x)),
                   approximate="tanh")
        return x + self._conv1d(blk.mlp.c_proj, h)

    def _block_weights(self, blk, x, mask):
        """One layer on the plain path, (x, weights (B, H, T, T))."""
        Bsz, T, C = x.shape
        qkv = self._conv1d(blk.attn.c_attn, blk.ln_1(x)).reshape(
            Bsz, T, 3, self.n_head, C // self.n_head)
        attn, weights = FA.multihead_attention(
            qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], mask,
            return_weights=True)
        x = x + self._conv1d(blk.attn.c_proj, attn.reshape(Bsz, T, C))
        return self._mlp(blk, x), weights

    def forward_hidden(self, embeds, *, collect_attn=False, impl="kernel"):
        """One full causal pass: embeds (B, T, C) -> (last hidden (B, T, C),
        weights (B, n_layer, H, T, T) or None)."""
        T = embeds.shape[1]
        x = embeds + self.gpt_model.wpe.weight[:T]
        mask = L.neg_inf_causal_mask(T, device=x.device)
        if collect_attn:
            attns = []
            for blk in self.gpt_model.h:
                x, w = self._block_weights(blk, x, mask)
                attns.append(w)
            return self.gpt_model.ln_f(x), torch.stack(attns, dim=1)
        layer_fn = (FG.fused_gpt2_block if impl == "kernel"
                    else FG.fused_gpt2_block_plain)
        for blk in self.gpt_model.h:
            x = layer_fn(x, dict(blk.named_parameters()), mask,
                         num_heads=self.n_head, eps=LN_EPS)
        return self.gpt_model.ln_f(x), None

    # -- KV-cache decode (multi-step rollouts) ---------------------------
    def _block_cached(self, blk, x, kc, vc, pos, impl):
        """One layer over the new tokens x (B, S, C) with this layer's
        preallocated (B, Tmax, H, hd) k / v caches, which get this step's
        k / v written in place at ``pos``. q is a column slice of the packed
        c_attn output and the caches are read whole, their unwritten slots
        masked; the attention kernel takes both as they lie."""
        Bsz, S, C = x.shape
        qkv = self._conv1d(blk.attn.c_attn, blk.ln_1(x)).reshape(
            Bsz, S, 3, self.n_head, C // self.n_head)  # [q | k | v] packing
        kc[:, pos:pos + S] = qkv[:, :, 1]
        vc[:, pos:pos + S] = qkv[:, :, 2]
        key_pos = torch.arange(kc.shape[1], device=x.device)[None, :]
        query_pos = pos + torch.arange(S, device=x.device)[:, None]
        mask = torch.zeros((S, kc.shape[1]), device=x.device).masked_fill(
            key_pos > query_pos, float("-inf"))
        if impl == "kernel":
            attn = FA.fused_attention(qkv[:, :, 0], kc, vc, mask)
        else:
            attn, _ = FA.attention_plain(qkv[:, :, 0], kc, vc, mask)
        x = x + self._conv1d(blk.attn.c_proj, attn.reshape(Bsz, S, C))
        return self._mlp(blk, x)

    def _apply_kv_cache(self, feats, output_len: int, impl="kernel"):
        """Eval-mode rollout with a KV cache: prefill the T tokens once,
        then decode ``output_len - 1`` single tokens (the reference's
        past_key_values loop, models/future_prediction.py:396-412)."""
        Bsz, T, C = feats.shape
        shape = (Bsz, T + output_len - 1, self.n_head, C // self.n_head)
        caches = [(feats.new_zeros(shape), feats.new_zeros(shape))
                  for _ in self.gpt_model.h]

        def run(tokens, pos):
            x = tokens + self.gpt_model.wpe.weight[pos:pos + tokens.shape[1]]
            for blk, (kc, vc) in zip(self.gpt_model.h, caches):
                x = self._block_cached(blk, x, kc, vc, pos, impl)
            return self.gpt_model.ln_f(x)

        outputs = [run(feats, 0)]                      # prefill: (B, T, C)
        for i in range(output_len - 1):
            # the next input is the last hidden state after ln_f
            outputs.append(run(outputs[-1][:, -1:, :], T + i))
        return torch.cat(outputs, dim=1), {}

    def _apply_full(self, feats, output_len: int, *, collect_attn=False,
                    impl="kernel"):
        """Every step re-runs the whole sequence (the JAX package's
        reference-faithful loop, predictor.py:306-329)."""
        endpoints = {}
        T = feats.shape[1]
        embeds = feats
        for output_id in range(output_len):
            total = embeds.shape[1]
            hidden, attn = self.forward_hidden(
                embeds, collect_attn=collect_attn, impl=impl)
            if attn is not None:
                # (B, n_layer, H, new tokens, total), as reference :409
                new = T if output_id == 0 else 1
                endpoints[f"gpt2_att_{output_id}"] = \
                    attn[:, :, :, total - new:]
            if output_id + 1 < output_len:
                embeds = torch.cat([embeds, hidden[:, -1:, :]], dim=1)
        return hidden, endpoints

    def forward(self, feats, output_len: int = 1, *, impl="kernel"):
        """feats (B, T, C) -> (hidden (B, T + output_len - 1, C), extra
        endpoints: {} or the ``gpt2_att_{step}`` attention weights)."""
        check_impl(impl)
        if output_len > 1 and not self.output_attentions:
            return self._apply_kv_cache(feats, output_len, impl)
        return self._apply_full(feats, output_len,
                                collect_attn=self.output_attentions,
                                impl=impl)
