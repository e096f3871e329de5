"""The SA-Fuser (``ModalTokenCMFuser``) and its block stack.

Port of afft_tpu/models/fusion.py ``_BlockStack`` and ``ModalTokenCMFuser``
(reference models/fusion.py:273-365): per-timestep self-attention over
[modal_token, m1 .. mn]; the fused output is the token slot 0. State-dict
names are the reference's: ``blocks.N.*``, ``norm``, ``modal_token``,
``modality_embedding``.

Without attention weights, each block of the stack runs as
``ops.fused_block`` (the CUDA kernel on a CUDA tensor, its plain version on
a CPU tensor) on the (B*T, N, C) layout, which the kernel takes as it is.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from . import layers as L
from .blocks import Block
from ..ops import fused_block as FB

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
        """x (R, N, C) -> (normed x, [per-block weights] or None)."""
        check_impl(impl)
        if need_weights:
            weights = []
            for blk in self.blocks:
                x, w = blk(x, mask)
                weights.append(w)
            return self.norm(x), weights
        block_fn = FB.fused_block if impl == "kernel" else FB.fused_block_plain
        for blk in self.blocks:
            x = block_fn(x, dict(blk.named_parameters()), mask,
                         num_heads=self.num_heads, eps=self.norm_eps)
        return self.norm(x), None


def _stack_modal_attn(weights, Bsz, T):
    # each (B*T, H, n, n) -> (B, depth, T, H, n, n)
    return torch.stack([w.reshape(Bsz, T, *w.shape[1:]) for w in weights],
                       dim=1)


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
        shapes = {tuple(v.shape) for v in modal_feats.values()}
        if len(shapes) != 1:
            raise ValueError(f"fuser inputs must share a shape, got {shapes}")
        Bsz, T, C = next(iter(shapes))
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
