"""Mixup with ignore-class handling.

Port of afft_tpu/train/mixup.py (reference common/mixup.py). The reference
gathers the rows whose past labels hold no ignore class and mixes them with
their flipped order (:75-87); here, as in the JAX package, that is a partner
permutation over the same selected rows, computed with tensor ops only (no
value is read back to the host). With at most one mixable row the batch
passes through unmixed (reference :155-157), expressed as lambda := 1.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F


def convert_to_one_hot(targets, num_class: int, label_smooth: float = 0.0):
    """(...,) int -> (..., C) fp32 with smoothing (reference :17-47)."""
    non_target = label_smooth / num_class
    target_value = 1.0 - label_smooth + non_target
    oh = F.one_hot(targets, num_class).float()
    return non_target + (target_value - non_target) * oh


def batch_wo_ignore_cls(target_subclips, ignore_cls=-1):
    """(B, T, 1) or (B, T) -> (B,) rows without an ignore label."""
    t = target_subclips.reshape(target_subclips.shape[0], -1)
    return (t != ignore_cls).all(dim=-1)


def _partner_perm(sel):
    """Row index of each selected row's mixing partner: the selected rows in
    flipped order; unselected rows point at themselves."""
    B = sel.shape[0]
    rows = torch.arange(B, device=sel.device)
    pos = torch.cumsum(sel.long(), 0) - 1          # position among selected
    total = sel.sum()
    pos_to_row = torch.zeros(B + 1, dtype=torch.long, device=sel.device)
    pos_to_row[torch.where(sel, pos, torch.full_like(pos, B))] = rows
    partner = pos_to_row[torch.where(sel, total - 1 - pos,
                                     torch.full_like(pos, B))]
    return torch.where(sel, partner, rows)


def _mix(x, sel, partner, lam):
    mixed = lam.to(x.dtype) * x + (1.0 - lam).to(x.dtype) * x[partner]
    return torch.where(sel.reshape((-1,) + (1,) * (x.dim() - 1)), mixed, x)


class MixUp:
    """Feature-space mixup (reference common/mixup.py:90-182) over
    {mod: (B, T, F)} features and label dicts. Returns (features, soft
    labels, soft subclip labels or None, subclip ignore masks or None)."""

    def __init__(self, alpha: float = 1.0, label_smoothing: Dict = None,
                 num_classes: Dict = None, one_hot: bool = False,
                 ignore_cls: int = -1):
        self.alpha = alpha
        self.label_smoothing = label_smoothing or {}
        self.num_classes = num_classes
        self.one_hot = one_hot
        self.ignore_cls = ignore_cls

    def __call__(self, gen: torch.Generator, x_video: Dict, labels: Dict,
                 labels_subclips: Optional[Dict], valid=None):
        """Draw lambda (``draw``) and mix."""
        return self.mix(self.draw(gen), x_video, labels, labels_subclips,
                        valid)

    def draw(self, gen: torch.Generator):
        """lambda ~ Beta(alpha, alpha) from ``gen`` (two Gamma draws on the
        generator's device), a 0-d fp32 tensor."""
        # float64: at alpha = 0.1 a float32 Gamma draw can underflow to 0
        shape = torch.full((2,), float(self.alpha), dtype=torch.float64,
                           device=gen.device)
        g = torch._standard_gamma(shape, generator=gen)
        return (g[0] / (g[0] + g[1]).clamp(min=1e-300)).float()

    def mix(self, lam, x_video: Dict, labels: Dict,
            labels_subclips: Optional[Dict], valid=None):
        """Mix with a given lambda (a float or a 0-d tensor)."""
        first_x = next(iter(x_video.values()))
        device = first_x.device
        lam = torch.as_tensor(lam, dtype=torch.float32, device=device)
        labels_out = {
            key: convert_to_one_hot(val, self.num_classes[key],
                                    self.label_smoothing.get(key, 0.0))
            for key, val in labels.items()}

        B = first_x.shape[0]
        if labels_subclips is not None:
            first = next(iter(labels_subclips.values()))
            sel = batch_wo_ignore_cls(first, self.ignore_cls)
            labels_subclips_out, ignore_masks = {}, {}
            for key, val in labels_subclips.items():
                val = val.reshape(val.shape[0], -1)       # (B, T)
                ignore = val == self.ignore_cls
                safe = torch.where(ignore, torch.zeros_like(val), val)
                ignore_masks[key] = ignore
                labels_subclips_out[key] = convert_to_one_hot(
                    safe, self.num_classes[key],
                    self.label_smoothing.get(key, 0.0))
        else:
            sel = torch.ones((B,), dtype=torch.bool, device=device)
            labels_subclips_out, ignore_masks = None, None

        if valid is not None:
            # padded rows of a fixed-shape final batch never take part
            sel = sel & valid

        # at most one mixable row: pass through unmixed (lam := 1)
        lam = torch.where(sel.sum() <= 1, torch.ones_like(lam), lam)
        partner = _partner_perm(sel)

        x_out = {m: _mix(x, sel, partner, lam) for m, x in x_video.items()}
        labels_out = {k: _mix(v, sel, partner, lam)
                      for k, v in labels_out.items()}
        if labels_subclips_out is not None:
            labels_subclips_out = {k: _mix(v, sel, partner, lam)
                                   for k, v in labels_subclips_out.items()}
        return x_out, labels_out, labels_subclips_out, ignore_masks
