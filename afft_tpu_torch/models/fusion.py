"""The transformer fusers and their shared block stack.

Port of afft_tpu/models/fusion.py (reference models/fusion.py):
- ``ModalTokenCMFuser`` (SA-Fuser, :273-365): per-timestep self-attention
  over [modal_token, m1 .. mn]; the fused output is the token slot 0;
- ``CMFuser`` (SA-Fuser without the token, :61-118): the same over
  [m1 .. mn]; the fused output is the mean over the modalities;
- ``TemporalCMFuser`` (T-SA-Fuser, :121-215): joint temporal and modal
  attention over (B, n*T, C) with a causal mask tiled over the modalities;
- ``TemporalCrossAttentFuser`` (CA-Fuser, :218-270): the first modality is
  the query stream; decoder block i cross-attends into modality i + 1.
State-dict names are the reference's: ``blocks.N.*``, ``norm``,
``modal_token``, ``modality_embedding``, ``position_embeddings.weight``.

Without attention weights, each block of a stack runs as a kernel of
``ops`` (the CUDA kernel on a CUDA tensor, its plain version on a CPU
tensor): ``fused_block`` for up to 8 tokens a row, ``fused_seq_block``
for longer sequences, ``fused_decoder_block`` for the CA-Fuser.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from . import layers as L
from .blocks import Block, DecoderBlock
from ..ops import fused_block as FB
from ..ops import fused_seq_block as FS

IMPLS = ("kernel", "plain")


def check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


class _BlockStack(nn.Module):
    """A depth-N stack of pre-LN blocks plus the final norm."""

    def __init__(self, dim, depth, num_heads, mlp_ratio=4.0, qkv_bias=False,
                 norm_affine=True, norm_eps=1e-6):
        super().__init__()
        self.num_heads = num_heads
        self.norm_eps = norm_eps
        self.blocks = nn.ModuleList([
            Block(dim, num_heads, mlp_ratio, qkv_bias, norm_affine, norm_eps)
            for _ in range(depth)])
        self.norm = nn.LayerNorm(dim, eps=norm_eps,
                                 elementwise_affine=norm_affine)

    def reset_parameters(self, gen):
        for blk in self.blocks:
            blk.reset_parameters(gen)
        L.init_layer_norm(self.norm)

    def run_stack(self, x, mask=None, *, need_weights=False, impl="kernel"):
        """x (R, N, C) -> (normed x, [per-block weights] or None).

        Rows of up to 8 tokens (the per-timestep fusers) go through
        ``fused_block``, longer sequences (the T-SA-Fuser) through
        ``fused_seq_block``, as the JAX package dispatches them."""
        check_impl(impl)
        if need_weights:
            weights = []
            for blk in self.blocks:
                x, w = blk(x, mask)
                weights.append(w)
            return self.norm(x), weights
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
        # dropout rates and drop-path are training-time only
        del qk_scale, embd_drop_rate, drop_rate, attn_drop_rate, \
            drop_path_rate
        super().__init__(dim, depth, num_heads, mlp_ratio, qkv_bias)
        self.cross_attn = cross_attn

    def forward(self, modal_feats, feats_order, *, need_weights=False,
                impl="kernel"):
        """{mod: (B, T, C)} -> (fused (B, T, C), weights or None)."""
        Bsz, T, C = _same_shape(modal_feats)
        n = len(feats_order)
        x = torch.stack([modal_feats[m] for m in feats_order], dim=2)
        x = x.reshape(Bsz * T, n, C)
        mask = (L.cross_attention_diag_mask(n, device=x.device)
                if self.cross_attn else None)
        x, weights = self.run_stack(x, mask, need_weights=need_weights,
                                    impl=impl)
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
        # dropout rates and drop-path are training-time only
        del qk_scale, embd_drop_rate, drop_rate, attn_drop_rate, \
            drop_path_rate
        super().__init__(dim, depth, num_heads, mlp_ratio, qkv_bias,
                         norm_affine=norm_elementwise)
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
                impl="kernel"):
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
        x, weights = self.run_stack(x, mask, need_weights=need_weights,
                                    impl=impl)
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
        # dropout rates and drop-path are training-time only
        del qk_scale, embd_drop_rate, drop_rate, attn_drop_rate, \
            drop_path_rate
        super().__init__(dim, depth, num_heads, mlp_ratio, qkv_bias)
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
                impl="kernel"):
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
        x, weights = self.run_stack(x, mask, need_weights=need_weights,
                                    impl=impl)
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
        # dropout rates and drop-path are training-time only
        del qk_scale, embd_drop_rate, drop_rate, attn_drop_rate, \
            drop_path_rate
        super().__init__()
        self.num_heads = num_heads
        self.blocks = nn.ModuleList([
            DecoderBlock(dim, None, num_heads, mlp_ratio, qkv_bias,
                         norm_eps=self.NORM_EPS)
            for _ in range(len(modalities) - 1)])
        self.norm = nn.LayerNorm(dim, eps=self.NORM_EPS)
        self.position_embeddings = nn.Embedding(max_position_embeddings, dim)

    def reset_parameters(self, gen):
        L.normal_(self.position_embeddings.weight, 1.0, gen)
        for blk in self.blocks:
            blk.reset_parameters(gen)
        L.init_layer_norm(self.norm)

    def forward(self, modal_feats, feats_order, *, need_weights=False,
                impl="kernel"):
        """{mod: (B, T, C)} -> (fused (B, T, C), zeros (B,))."""
        del need_weights  # the decoder blocks return no weights
        check_impl(impl)
        Bsz, T, C = _same_shape(modal_feats)
        pos = self.position_embeddings.weight[:T]
        x, *mems = [modal_feats[m] + pos for m in feats_order]
        mask = L.neg_inf_causal_mask(T, device=x.device)
        for blk, mem in zip(self.blocks, mems):
            x = blk(x, mem, mask, impl=impl)
        return self.norm(x), x.new_zeros((Bsz,))
