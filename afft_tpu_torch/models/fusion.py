"""The transformer fusers and their shared block stack.

Port of afft_tpu/models/fusion.py (reference models/fusion.py):
- ``ModalTokenCMFuser`` (SA-Fuser, :273-365): per-timestep self-attention
  over [modal_token, m1 .. mn]; the fused output is the token slot 0;
- ``CMFuser`` (SA-Fuser without the token, :61-118): the same over
  [m1 .. mn]; the fused output is the mean over the modalities;
- ``TemporalCMFuser`` (T-SA-Fuser, :121-215): joint temporal and modal
  attention over (B, n*T, C) with a causal mask tiled over the modalities;
- ``TemporalCrossAttentFuser`` (CA-Fuser, :218-270): the first modality is
  the query stream; decoder block i cross-attends into modality i + 1;
- ``MATT`` (:35-58, RULSTM's modality attention): an MLP over the
  concatenated modalities, softmax over them; the score-fusion CMFP's
  weights.
State-dict names are the reference's: ``blocks.N.*``, ``norm``,
``modal_token``, ``modality_embedding``, ``position_embeddings.weight``,
``matt.0`` / ``matt.3`` / ``matt.6``.

Without attention weights, each block of a stack runs as a kernel of
``ops`` (the CUDA kernel on a CUDA tensor, its plain version on a CPU
tensor): ``fused_block`` for up to 8 tokens a row, ``fused_seq_block``
for longer sequences, ``fused_decoder_block`` for the CA-Fuser.

In training mode the per-timestep fusers (``ModalTokenCMFuser``,
``CMFuser``) send each block through ``ops.fused_block_train`` (forward and
backward CUDA kernels under autograd; its plain version on a CPU tensor):
one pair of seed words per stack call, the block's position as its block
index, the drop-path rate rising linearly over the stack, the final norm
outside (afft_tpu/models/fusion.py:65-90). With attention weights asked
for, the blocks run as modules. The T-SA-Fuser's sequences are longer than
that kernel takes: its blocks train as modules under autograd (the XLA
branch of the JAX stack, :120-129), their attention through
``layers.attention``, so row 4's kernel runs where no attention
dropout is in force. The CA-Fuser trains its decoder blocks as modules the
same way (:346-409). Every dropout and drop-path draws through
``layers.dropout`` / ``layers.drop_path`` (the global batch's rows under
data parallelism).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from . import layers as L
from .blocks import Block, DecoderBlock
from ..ops import fused_block as FB
from ..ops import fused_block_train as FT
from ..ops import fused_seq_block as FS
from ..ops._common import shard_reason

IMPLS = ("kernel", "plain")


def check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


class _BlockStack(nn.Module):
    """A depth-N stack of pre-LN blocks plus the final norm."""

    def __init__(self, dim, depth, num_heads, mlp_ratio=4.0, qkv_bias=False,
                 norm_affine=True, norm_eps=1e-6, drop_rate=0.0,
                 attn_drop_rate=0.0, drop_path_rate=0.0):
        super().__init__()
        self.num_heads = num_heads
        self.norm_eps = norm_eps
        self.drop_rate = drop_rate
        self.attn_drop_rate = attn_drop_rate
        self.dpr = L.drop_path_schedule(drop_path_rate, depth)
        self.blocks = nn.ModuleList([
            Block(dim, num_heads, mlp_ratio, qkv_bias, norm_affine, norm_eps,
                  drop=drop_rate, attn_drop=attn_drop_rate, drop_path=dp)
            for dp in self.dpr])
        self.norm = nn.LayerNorm(dim, eps=norm_eps,
                                 elementwise_affine=norm_affine)
        # parallel.sharding.TensorParallel, when the blocks' MLPs are
        # sharded over a model group
        self.tensor_parallel = None

    def reset_parameters(self, gen):
        for blk in self.blocks:
            blk.reset_parameters(gen)
        L.init_layer_norm(self.norm)

    def tp_blocks(self, count: int):
        """The blocks tensor parallelism may shard over ``count`` model
        ranks (``parallel.sharding.plan_model``): (index, block, why it
        stays whole or None, the prefixes of the norms whose gradients a
        shard leaves partial). Their MLP shards; the blocks of rows of up
        to 8 tokens (the SA-Fusers) run on the kernels' shard mode."""
        rows = isinstance(self, (CMFuser, ModalTokenCMFuser))
        for i, blk in enumerate(self.blocks):
            hidden, C = blk.mlp.mlp[0].weight.shape
            why = shard_reason(C, self.num_heads, hidden, count,
                               split_heads=False) if rows \
                else "its blocks train as modules (not the kernels)"
            yield i, blk, why, ("norm2.",)

    def _train_stack(self, x, mask, impl, rng):
        """The training dispatch: rows of up to 8 tokens through
        ``fused_block_train`` (``impl="plain"``: its plain version on masks
        from ``draw_masks``, which are the kernels' own); longer sequences
        (the T-SA-Fuser) through the blocks as modules under autograd."""
        R, N, C = x.shape
        rates = (self.attn_drop_rate, self.drop_rate)
        if rng is None and (any(rates) or any(self.dpr)):
            raise ValueError("training with a dropout or drop-path rate > 0 "
                             "needs an RngStream")
        tp = self.tensor_parallel
        if N > FB.MAX_TOKENS:
            if tp is not None and any(tp.sharded(b) for b in self.blocks):
                raise ValueError("tensor parallelism shards the blocks of "
                                 "rows of up to 8 tokens only")
            for blk in self.blocks:
                x, _ = blk(x, mask, rng=rng, need_weights=False, impl=impl)
            return self.norm(x), None
        seeds = (0, 0) if rng is None else rng.seed_words()
        row0 = 0 if rng is None else rng.row_offset(R)
        for bi, (blk, dp) in enumerate(zip(self.blocks, self.dpr)):
            params = dict(blk.named_parameters())
            # a sharded block: this model rank's MLP columns (tensor
            # parallelism), the output summed over the model group
            shard = tp.shard() if tp is not None and tp.sharded(blk) else None
            if impl == "kernel":
                x = FT.fused_block_train(
                    x, params, mask, seeds, num_heads=self.num_heads,
                    block_idx=bi, attn_rate=rates[0], drop_rate=rates[1],
                    dp_rate=dp, eps=self.norm_eps, row0=row0, shard=shard)
                continue
            masks = FT.draw_masks(R, N, C, self.num_heads, seeds, bi,
                                  *rates, dp, device=x.device, row0=row0)
            if shard is not None:
                x = FT.fused_block_train_shard_plain(
                    x, params, mask, masks, num_heads=self.num_heads,
                    shard=shard, eps=self.norm_eps)
            else:
                x = FT.fused_block_train_plain(
                    x, params, mask, masks, num_heads=self.num_heads,
                    eps=self.norm_eps)
        return self.norm(x), None

    def run_stack(self, x, mask=None, *, need_weights=False, impl="kernel",
                  rng=None):
        """x (R, N, C) -> (normed x, [per-block weights] or None).

        Rows of up to 8 tokens (the per-timestep fusers) go through
        ``fused_block``, longer sequences (the T-SA-Fuser) through
        ``fused_seq_block``, as the JAX package dispatches them; in
        training mode as ``_train_stack`` dispatches them."""
        check_impl(impl)
        if self.tensor_parallel is not None and (need_weights
                                                 or not self.training):
            raise ValueError("evaluation and the attention weights need "
                             "whole fuser blocks: gather the model "
                             "(runner.model_state()) and run it in one "
                             "process")
        if need_weights:
            weights = []
            for blk in self.blocks:
                x, w = blk(x, mask, rng=rng)
                weights.append(w)
            return self.norm(x), weights
        if self.training:
            return self._train_stack(x, mask, impl, rng)
        if x.shape[1] <= FB.MAX_TOKENS:
            block_fn = (FB.fused_block if impl == "kernel"
                        else FB.fused_block_plain)
        else:
            block_fn = (FS.fused_seq_block if impl == "kernel"
                        else FS.fused_seq_block_plain)
        for blk in self.blocks:
            x = block_fn(x, dict(blk.named_parameters()), mask,
                         num_heads=self.num_heads, eps=self.norm_eps)
        return self.norm(x), None


def _same_shape(modal_feats):
    shapes = {tuple(v.shape) for v in modal_feats.values()}
    if len(shapes) != 1:
        raise ValueError(f"fuser inputs must share a shape, got {shapes}")
    return next(iter(shapes))


def _stack_modal_attn(weights, Bsz, T):
    # each (B*T, H, n, n) -> (B, depth, T, H, n, n)
    return torch.stack([w.reshape(Bsz, T, *w.shape[1:]) for w in weights],
                       dim=1)


class CMFuser(_BlockStack):
    """SA-Fuser without the modality token: self-attention over [m1..mn]
    per timestep, fused output = mean over the modalities."""

    def __init__(self, dim, depth=1, num_heads=4, mlp_ratio=4.0,
                 qkv_bias=False, qk_scale=None, embd_drop_rate=0.0,
                 drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=0.0,
                 cross_attn=False, **_ignored):
        del qk_scale
        super().__init__(dim, depth, num_heads, mlp_ratio, qkv_bias,
                         drop_rate=drop_rate, attn_drop_rate=attn_drop_rate,
                         drop_path_rate=drop_path_rate)
        self.embd_drop_rate = embd_drop_rate
        self.cross_attn = cross_attn

    def forward(self, modal_feats, feats_order, *, need_weights=False,
                impl="kernel", rng=None):
        """{mod: (B, T, C)} -> (fused (B, T, C), weights or None)."""
        Bsz, T, C = _same_shape(modal_feats)
        n = len(feats_order)
        x = torch.stack([modal_feats[m] for m in feats_order], dim=2)
        x = x.reshape(Bsz * T, n, C)
        mask = (L.cross_attention_diag_mask(n, device=x.device)
                if self.cross_attn else None)
        x = L.dropout(x, self.embd_drop_rate, self.training, rng)
        x, weights = self.run_stack(x, mask, need_weights=need_weights,
                                    impl=impl, rng=rng)
        fused = x.mean(dim=1).reshape(Bsz, T, C)
        attn = _stack_modal_attn(weights, Bsz, T) if need_weights else None
        return fused, attn


class ModalTokenCMFuser(_BlockStack):
    """SA-Fuser: self-attention over [modal_token, m1..mn] per timestep."""

    def __init__(self, dim, depth=1, num_heads=4, mlp_ratio=4.0,
                 qkv_bias=False, qk_scale=None, embd_drop_rate=0.0,
                 drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=0.0,
                 norm_elementwise=True, cross_attn=False, modalities=None,
                 modal_encoding=False, frame_level_token=False,
                 temporal_sequence_length=None, **_ignored):
        del qk_scale
        super().__init__(dim, depth, num_heads, mlp_ratio, qkv_bias,
                         norm_affine=norm_elementwise, drop_rate=drop_rate,
                         attn_drop_rate=attn_drop_rate,
                         drop_path_rate=drop_path_rate)
        self.embd_drop_rate = embd_drop_rate
        self.cross_attn = cross_attn
        self.num_mods = len(modalities) + 1  # + the modality-agnostic token
        self.modal_encoding = modal_encoding
        self.frame_level_token = frame_level_token
        self.temporal_sequence_length = temporal_sequence_length
        if frame_level_token and temporal_sequence_length is None:
            raise ValueError("frame_level_token needs "
                             "temporal_sequence_length")
        tok_len = temporal_sequence_length if frame_level_token else 1
        self.modal_token = nn.Parameter(torch.zeros(1, tok_len, dim))
        if modal_encoding:
            self.modality_embedding = nn.Parameter(
                torch.zeros(1, self.num_mods, dim))

    def reset_parameters(self, gen):
        super().reset_parameters(gen)
        L.normal_(self.modal_token, 0.02, gen)
        if self.modal_encoding:
            L.normal_(self.modality_embedding, 0.02, gen)

    def forward(self, modal_feats, feats_order, *, need_weights=False,
                impl="kernel", rng=None):
        """{mod: (B, T, C)} -> (fused (B, T, C), weights or None)."""
        Bsz, T, C = _same_shape(modal_feats)
        x = torch.stack([modal_feats[m] for m in feats_order], dim=2)
        x = x.reshape(Bsz * T, len(feats_order), C)
        if not self.frame_level_token:
            tokens = self.modal_token.expand(Bsz * T, 1, C)
        else:
            if self.temporal_sequence_length != T:
                raise ValueError(f"{T} frames, the frame-level tokens are "
                                 f"{self.temporal_sequence_length}")
            tokens = self.modal_token.expand(Bsz, T, C).reshape(Bsz * T, 1, C)
        x = torch.cat([tokens.to(x.dtype), x], dim=1)
        if self.modal_encoding:
            x = x + self.modality_embedding
        mask = (L.cross_attention_diag_mask(self.num_mods, device=x.device)
                if self.cross_attn else None)
        x = L.dropout(x, self.embd_drop_rate, self.training, rng)
        x, weights = self.run_stack(x, mask, need_weights=need_weights,
                                    impl=impl, rng=rng)
        fused = x[:, 0, :].reshape(Bsz, T, C)
        attn = _stack_modal_attn(weights, Bsz, T) if need_weights else None
        return fused, attn


class TemporalCMFuser(_BlockStack):
    """T-SA-Fuser: joint temporal and modal attention over (B, n*T, C) with
    a causal mask tiled over the modalities."""

    def __init__(self, dim, depth=1, num_heads=4, mlp_ratio=4.0,
                 qkv_bias=False, qk_scale=None, embd_drop_rate=0.0,
                 drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=0.0,
                 modalities=None, modal_encoding=True,
                 frame_level_token=False, temporal_sequence_length=None,
                 max_position_embeddings=64, **_ignored):
        del qk_scale
        super().__init__(dim, depth, num_heads, mlp_ratio, qkv_bias,
                         drop_rate=drop_rate, attn_drop_rate=attn_drop_rate,
                         drop_path_rate=drop_path_rate)
        self.embd_drop_rate = embd_drop_rate
        self.num_mods = len(modalities) + (1 if frame_level_token else 0)
        self.modal_encoding = modal_encoding
        self.frame_level_token = frame_level_token
        self.temporal_sequence_length = temporal_sequence_length
        if frame_level_token and temporal_sequence_length is None:
            raise ValueError("frame_level_token needs "
                             "temporal_sequence_length")
        self.position_embeddings = nn.Embedding(max_position_embeddings, dim)
        if frame_level_token:
            self.modal_token = nn.Parameter(
                torch.zeros(1, temporal_sequence_length, dim))
        if modal_encoding:
            self.modality_embedding = nn.Parameter(
                torch.zeros(self.num_mods, dim))

    def reset_parameters(self, gen):
        super().reset_parameters(gen)
        L.normal_(self.position_embeddings.weight, 1.0, gen)
        if self.frame_level_token:
            L.normal_(self.modal_token, 0.02, gen)
        if self.modal_encoding:
            L.normal_(self.modality_embedding, 0.02, gen)

    def forward(self, modal_feats, feats_order, *, need_weights=False,
                impl="kernel", rng=None):
        """{mod: (B, T, C)} -> (fused (B, T, C), weights (B, depth, H, n*T,
        n*T) or None)."""
        Bsz, T, C = _same_shape(modal_feats)
        n = self.num_mods
        x = torch.cat([modal_feats[m] for m in feats_order], dim=1)
        if self.frame_level_token:
            if self.temporal_sequence_length != T:
                raise ValueError(f"{T} frames, the frame-level tokens are "
                                 f"{self.temporal_sequence_length}")
            tokens = self.modal_token.expand(Bsz, T, C)
            x = torch.cat([tokens.to(x.dtype), x], dim=1)
        if x.shape[1] != n * T:
            raise ValueError(f"{x.shape[1] // T} token streams, the fuser "
                             f"was built for {n}")
        # positions are tiled over the modalities, the modality embedding is
        # repeated over the frames
        x = x + self.position_embeddings.weight[:T].repeat(n, 1)
        if self.modal_encoding:
            x = x + self.modality_embedding.repeat_interleave(T, dim=0)
        mask = L.neg_inf_causal_mask(T, device=x.device).repeat(n, n)
        x = L.dropout(x, self.embd_drop_rate, self.training, rng)
        x, weights = self.run_stack(x, mask, need_weights=need_weights,
                                    impl=impl, rng=rng)
        if self.frame_level_token:
            fused = x[:, :T, :]
        else:  # mean over the modality copies of each frame slot
            fused = x.reshape(Bsz, n, T, C).mean(dim=1)
        attn = torch.stack(weights, dim=1) if need_weights else None
        return fused, attn


class TemporalCrossAttentFuser(nn.Module):
    """CA-Fuser: the first modality is the query stream; decoder block i
    cross-attends into modality i + 1 under a causal mask. The second
    return value is a placeholder, as in the reference."""

    NORM_EPS = 1e-6

    def __init__(self, dim, modalities=None, num_heads=4, mlp_ratio=4.0,
                 qkv_bias=False, qk_scale=None, embd_drop_rate=0.0,
                 drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=0.0,
                 max_position_embeddings=128, **_ignored):
        del qk_scale
        super().__init__()
        self.num_heads = num_heads
        self.embd_drop_rate = embd_drop_rate
        self.drop_rate = drop_rate
        self.attn_drop_rate = attn_drop_rate
        self.dpr = L.drop_path_schedule(drop_path_rate, len(modalities) - 1)
        self.blocks = nn.ModuleList([
            DecoderBlock(dim, None, num_heads, mlp_ratio, qkv_bias,
                         norm_eps=self.NORM_EPS, drop=drop_rate,
                         attn_drop=attn_drop_rate, drop_path=dp)
            for dp in self.dpr])
        self.norm = nn.LayerNorm(dim, eps=self.NORM_EPS)
        self.position_embeddings = nn.Embedding(max_position_embeddings, dim)

    def reset_parameters(self, gen):
        L.normal_(self.position_embeddings.weight, 1.0, gen)
        for blk in self.blocks:
            blk.reset_parameters(gen)
        L.init_layer_norm(self.norm)

    def forward(self, modal_feats, feats_order, *, need_weights=False,
                impl="kernel", rng=None):
        """{mod: (B, T, C)} -> (fused (B, T, C), zeros (B,)). In training
        mode the embedding dropout falls on every stream and the decoder
        blocks run their training path."""
        del need_weights  # the decoder blocks return no weights
        check_impl(impl)
        Bsz, T, C = _same_shape(modal_feats)
        pos = self.position_embeddings.weight[:T]
        x, *mems = [L.dropout(modal_feats[m] + pos, self.embd_drop_rate,
                              self.training, rng) for m in feats_order]
        mask = L.neg_inf_causal_mask(T, device=x.device)
        if self.training and rng is None and (
                self.drop_rate or self.attn_drop_rate or any(self.dpr)):
            raise ValueError("training with a dropout or drop-path rate > 0 "
                             "needs an RngStream")
        for blk, mem in zip(self.blocks, mems):
            x = blk(x, mem, mask, impl=impl, rng=rng)
        return self.norm(x), x.new_zeros((Bsz,))


class MATT(nn.Module):
    """RULSTM modality attention: Linear -> ReLU -> Dropout -> Linear ->
    ReLU -> Dropout -> Linear over the concatenated modalities (widths
    in, in / 4, in / 8, n), softmax over the modalities. ``in`` is
    ``dim * n`` when ``dim`` is set, else the sum of the modality widths.
    The Sequential keeps the reference's indices (``matt.0``, ``matt.3``,
    ``matt.6``); the two dropouts draw from the step's ``RngStream``."""

    def __init__(self, modal_dims, dim=None, drop_rate=0.8, **_ignored):
        super().__init__()
        n = len(modal_dims)
        in_size = dim * n if dim else sum(int(d) for d in
                                          modal_dims.values())
        self.num_modality = n
        self.drop_rate = drop_rate
        self.matt = nn.Sequential(
            nn.Linear(in_size, in_size // 4), nn.ReLU(), nn.Identity(),
            nn.Linear(in_size // 4, in_size // 8), nn.ReLU(), nn.Identity(),
            nn.Linear(in_size // 8, n))

    def reset_parameters(self, gen):
        for i in (0, 3, 6):
            L.init_torch_linear(self.matt[i], gen)

    def forward(self, modal_feats, feats_order, *, impl="kernel", rng=None):
        """{mod: (B, T, C_mod)} -> modality weights (B, T, n), in
        ``feats_order``."""
        del impl  # no kernel: the JAX package runs XLA here
        x = torch.cat([modal_feats[m] for m in feats_order], dim=2)
        for i in (0, 3):
            x = L.dropout(torch.relu(self.matt[i](x)), self.drop_rate,
                          self.training, rng)
        return self.matt[6](x).softmax(dim=-1)
