"""Causal future predictor: a GPT-2 over feature embeddings (no wte).

Port of afft_tpu/models/predictor.py ``BaseFuturePredictor`` (reference
models/future_prediction.py:354-415, an HF ``GPT2Model`` fed with
``inputs_embeds``): learned position embeddings, pre-LN blocks (eps 1e-5),
packed qkv with bias, causal attention, gelu_new MLP, final ``ln_f``.
State-dict names are HF's under ``gpt_model``: ``h.N.ln_1``,
``h.N.attn.c_attn`` (Conv1D (in, 3C), packed [q | k | v]), ``h.N.attn.c_proj``,
``h.N.ln_2``, ``h.N.mlp.c_fc``, ``h.N.mlp.c_proj``, ``wpe``, ``ln_f``.

In training mode (``_train_layers``) ``embd_pdrop`` drops on the embedded
input through ``layers.dropout``, and every layer runs as
``ops.fused_gpt2_train.fused_gpt2_block_train`` (forward and backward CUDA
kernels under autograd on a CUDA tensor, in fp32 and in bf16; its plain
version on a CPU tensor): ``attn_pdrop`` on the attention weights and
``resid_pdrop`` on both residual branches, drawn from one pair of seed words
per pass (afft_tpu/models/predictor.py:156-172), the layer's position as its
index. ``impl="plain"`` runs the plain version on the kernels' masks. With
attention weights asked for, the layers run in plain PyTorch ops under
autograd (``_block_train``, masks from the step's ``RngStream``), as the JAX
package leaves that path to XLA. The serving kernels have no backward and
raise when a gradient is required.

Three eval-mode paths, as in the JAX package:
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

Pipeline parallelism (``train.pipeline_stages``, ``parallel.pipeline``):
``pipeline(ctx)`` keeps the layers of this process's stage and drops the
others' (their weights live on the other stages' processes; state-dict names
keep the global layer index). The training layers and the single causal pass
then run as ``parallel.pipeline.run_stack``: this stage's layers on each
microbatch, each training layer at its global index and the microbatch's
first global row, so the masks are the unpipelined pass's. A multi-step eval
rollout re-runs the sequence through the stages (the KV cache holds every
layer on one process), and the attention weights are refused.

Tensor parallelism (``parallel.sharding.tensor_parallel`` sets
``tensor_parallel``): the sharded layers hold this model rank's heads and
MLP columns and train through ``fused_gpt2_block_train``'s shard mode, the
layer's output summed over the model group. With ``seq_ctx``
(``parallel.sharding.SeqCtx``, afft_tpu/models/predictor.py:135-147) the
residual stream between the layers is this rank's T-shard: the embedded
input is split over T before the first layer and gathered after the last,
and each layer keeps its input and y for the backward as T-shards.
Evaluation, the attention weights and the KV-cache rollout need whole
layers and are refused under tensor parallelism; sequence parallelism and
pipelining exclude each other, as in the JAX package.
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
from ..ops import fused_gpt2_train as FGT
from ..ops._common import shard_reason
from ..parallel import pipeline as P
from ..parallel import sharding as SH

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
        self.embd_pdrop = embd_pdrop
        self.resid_pdrop = resid_pdrop
        self.attn_pdrop = attn_pdrop
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
        self.pipeline_ctx = None
        self.tensor_parallel = None
        self.seq_ctx = None

    def tp_blocks(self, count: int):
        """The layers tensor parallelism may shard over ``count`` model
        ranks (``parallel.sharding.plan_model``): (index, layer, why it
        stays whole or None, the prefixes of the norms whose gradients a
        shard leaves partial) for each layer this process holds."""
        C = self.gpt_model.wpe.weight.shape[1]
        why = shard_reason(C, self.n_head, self.n_inner, count)
        for i, blk in enumerate(self.gpt_model.h):
            if hasattr(blk, "attn"):    # not another pipeline stage's layer
                yield i, blk, why, ("ln_1.", "ln_2.")

    def pipeline(self, ctx):
        """Run the layers over ``ctx``'s stages (``parallel.pipeline``):
        keep this stage's, drop the other stages' modules."""
        if self.output_attentions:
            raise ValueError("model.common.fp_output_attentions needs every "
                             "predictor layer in one process: train without "
                             "pipeline parallelism")
        self.pipeline_ctx = ctx
        for i in range(self.n_layer):
            if i not in ctx.layers:
                self.gpt_model.h[i] = nn.Module()

    def _layers(self):
        """(global index, layer) of the layers this process runs."""
        ctx = self.pipeline_ctx
        return [(i, blk) for i, blk in enumerate(self.gpt_model.h)
                if ctx is None or i in ctx.layers]

    def reset_parameters(self, gen):
        """GPT-2 init: N(0, 0.02), residual projections N(0, 0.02 /
        sqrt(2 n_layer)), zero biases, unit LayerNorms."""
        if self.pipeline_ctx is not None:
            raise RuntimeError("draw the weights before pipelining: each "
                               "stage keeps its share of one draw")
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

    def _block_train(self, blk, x, mask, rng):
        """One layer in training mode with its attention weights, plain ops
        under autograd (afft_tpu/models/predictor.py:105-126): (x, weights
        after their dropout (B, H, T, T))."""
        Bsz, T, C = x.shape
        hd = C // self.n_head
        q, k, v = (self._conv1d(blk.attn.c_attn, blk.ln_1(x))
                   .reshape(Bsz, T, 3, self.n_head, hd).permute(2, 0, 3, 1, 4))
        # the fp32 mask promotes the scores: softmax and dropout in fp32
        weights = ((q @ k.transpose(-1, -2)) * (hd ** -0.5)
                   + mask).softmax(dim=-1)
        weights = L.dropout(weights, self.attn_pdrop, True, rng)
        attn = (weights.to(v.dtype) @ v).transpose(1, 2).reshape(Bsz, T, C)
        x = x + L.dropout(self._conv1d(blk.attn.c_proj, attn),
                          self.resid_pdrop, True, rng)
        h = F.gelu(self._conv1d(blk.mlp.c_fc, blk.ln_2(x)),
                   approximate="tanh")
        h = self._conv1d(blk.mlp.c_proj, h)
        return x + L.dropout(h, self.resid_pdrop, True, rng), weights

    def _train_layers(self, x, mask, impl, rng):
        """The training dispatch: every layer through
        ``fused_gpt2_block_train`` on this pass's own pair of seed words
        (``impl="plain"``: its plain version on masks from
        ``draw_masks_gpt2``, which are the kernels' own)."""
        rates = (self.attn_pdrop, self.resid_pdrop)
        if rng is None and any(rates):
            raise ValueError("training with a dropout rate > 0 needs an "
                             "RngStream")
        seeds = (0, 0) if rng is None else rng.seed_words()
        rows, parts = x.shape[0], 1
        if self.pipeline_ctx is not None:
            parts = self.pipeline_ctx.microbatches
        tp = self.tensor_parallel
        sp = self._seq_parallel(x.shape[1])

        def stage(h, part):
            """This process's layers on ``part`` of ``parts`` of the
            batch."""
            row0 = part * (rows // parts) if rng is None \
                else rng.row_offset(rows, part, parts)
            for li, blk in self._layers():
                params = dict(blk.named_parameters())
                shard = tp.shard(sp) if tp is not None and tp.sharded(blk) \
                    else None
                if impl == "kernel":
                    h = FGT.fused_gpt2_block_train(
                        h, params, mask, seeds, num_heads=self.n_head,
                        layer_idx=li, attn_rate=rates[0],
                        resid_rate=rates[1], eps=LN_EPS, row0=row0,
                        shard=shard)
                    continue
                B, T, C = h.shape
                masks = FGT.draw_masks_gpt2(
                    B, T * (shard.count if sp else 1), C, self.n_head,
                    seeds, li, *rates, device=h.device, row0=row0)
                if shard is not None:
                    h = FGT.fused_gpt2_block_train_shard_plain(
                        h, params, mask, masks, num_heads=self.n_head,
                        shard=shard, eps=LN_EPS)
                else:
                    h = FGT.fused_gpt2_block_train_plain(
                        h, params, mask, masks, num_heads=self.n_head,
                        eps=LN_EPS)
            return h
        if sp:
            group = self.seq_ctx.group
            return SH.join_seq(stage(SH.split_seq(x, group), 0), group)
        if self.pipeline_ctx is None:
            return stage(x, 0)
        return P.run_stack(self.pipeline_ctx, x, stage, [
            p for _, blk in self._layers() for p in blk.parameters()])

    def _seq_parallel(self, T: int) -> bool:
        """Whether the training layers run T-sharded (``seq_ctx``): every
        layer sharded and T dividing over the model ranks."""
        if self.seq_ctx is None:
            return False
        if self.pipeline_ctx is not None:
            raise ValueError("seq_ctx and pipeline_ctx are mutually "
                             "exclusive")
        tp = self.tensor_parallel
        if tp is None or not all(tp.sharded(blk) for _, blk in self._layers()):
            raise ValueError("sequence parallelism needs every predictor "
                             "layer tensor-parallel")
        return self.seq_ctx.applies(T)

    def forward_hidden(self, embeds, *, collect_attn=False, impl="kernel",
                       rng=None):
        """One full causal pass: embeds (B, T, C) -> (last hidden (B, T, C),
        weights (B, n_layer, H, T, T) or None)."""
        if self.tensor_parallel is not None and (collect_attn
                                                 or not self.training):
            raise ValueError("evaluation and the attention weights need "
                             "whole predictor layers: gather the model "
                             "(runner.model_state()) and run it in one "
                             "process")
        T = embeds.shape[1]
        x = embeds + self.gpt_model.wpe.weight[:T]
        mask = L.neg_inf_causal_mask(T, device=x.device)
        if collect_attn and self.pipeline_ctx is not None:
            raise ValueError("the attention weights need every predictor "
                             "layer in one process (pipeline parallelism)")
        if self.training:
            x = L.dropout(x, self.embd_pdrop, True, rng)
            if not collect_attn:
                return self.gpt_model.ln_f(self._train_layers(x, mask, impl,
                                                              rng)), None
            attns = []
            for blk in self.gpt_model.h:
                x, w = self._block_train(blk, x, mask, rng)
                attns.append(w)
            return self.gpt_model.ln_f(x), torch.stack(attns, dim=1)
        if collect_attn:
            attns = []
            for blk in self.gpt_model.h:
                x, w = self._block_weights(blk, x, mask)
                attns.append(w)
            return self.gpt_model.ln_f(x), torch.stack(attns, dim=1)
        layer_fn = (FG.fused_gpt2_block if impl == "kernel"
                    else FG.fused_gpt2_block_plain)

        def stage(h, part=0):
            for _, blk in self._layers():
                h = layer_fn(h, dict(blk.named_parameters()), mask,
                             num_heads=self.n_head, eps=LN_EPS)
            return h
        if self.pipeline_ctx is not None:
            x = P.run_stack(self.pipeline_ctx, x, stage)
        else:
            x = stage(x)
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
                    impl="kernel", rng=None):
        """Every step re-runs the whole sequence (the JAX package's
        reference-faithful loop, predictor.py:306-329)."""
        endpoints = {}
        T = feats.shape[1]
        embeds = feats
        for output_id in range(output_len):
            total = embeds.shape[1]
            hidden, attn = self.forward_hidden(
                embeds, collect_attn=collect_attn, impl=impl, rng=rng)
            if attn is not None:
                # (B, n_layer, H, new tokens, total), as reference :409
                new = T if output_id == 0 else 1
                endpoints[f"gpt2_att_{output_id}"] = \
                    attn[:, :, :, total - new:]
            if output_id + 1 < output_len:
                embeds = torch.cat([embeds, hidden[:, -1:, :]], dim=1)
        return hidden, endpoints

    def forward(self, feats, output_len: int = 1, *, impl="kernel",
                rng=None):
        """feats (B, T, C) -> (hidden (B, T + output_len - 1, C), extra
        endpoints: {} or the ``gpt2_att_{step}`` attention weights). In
        training mode a multi-step rollout re-runs the whole sequence every
        step (dropout is drawn per pass), as the JAX package does."""
        check_impl(impl)
        n_positions = self.gpt_model.wpe.weight.shape[0]
        if feats.shape[1] + output_len - 1 > n_positions:
            raise ValueError(
                f"the predictor takes at most n_positions = {n_positions} "
                f"tokens; T {feats.shape[1]} + output_len {output_len} - 1 "
                "passes it")
        if output_len > 1 and not self.output_attentions \
                and not self.training and self.pipeline_ctx is None \
                and self.tensor_parallel is None:
            return self._apply_kv_cache(feats, output_len, impl)
        return self._apply_full(feats, output_len,
                                collect_attn=self.output_attentions,
                                impl=impl, rng=rng)
