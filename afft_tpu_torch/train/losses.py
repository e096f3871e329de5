"""Loss and per-batch metric computation.

Port of afft_tpu/train/losses.py (reference common/runner.py:13-168,
MultiDimCrossEntropy and BasicLossAccuracy). Row filtering is a
mask-weighted mean, and the padded rows of fixed-shape batches are left out
through a ``valid`` mask (valid = ones reproduces the reference). Nothing
here reads a value back to the host.

Losses come back per key (cls_* / past_cls_* / past_reg_*);
``reduce_losses`` weights and sums them with the reference's prefix-matched
loss weights (common/runner.py:171-213).

Data parallelism: every mean divides by its denominator over the global
batch (one small all-reduce of the denominator for each term over the
data ranks ``group``, through ``parallel.mesh``; the world by default, the
identity in one process), so each scalar here is this rank's share of the
one-process value over the global batch: the shares sum to it, and the
gradients of the shares sum to its gradient. A mean of the ranks' own
means would be wrong as soon as ``valid`` or the class weights differ
between ranks.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..parallel import mesh

PAST_LOGITS_PREFIX = "past_"


def cross_entropy_index(logits, tgt, ignore_index=-1):
    """Per-element CE with zeros at ignored targets (torch reduction='none'
    with ignore_index). logits (..., C), tgt (...)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ignored = tgt == ignore_index
    safe = torch.where(ignored, torch.zeros_like(tgt), tgt)
    ce = -logp.gather(-1, safe[..., None])[..., 0]
    return torch.where(ignored, torch.zeros_like(ce), ce)


def cross_entropy_one_hot(logits, tgt):
    """Per-element CE against one-hot or soft targets. logits (..., C)."""
    return -(tgt * F.log_softmax(logits.float(), dim=-1)).sum(dim=-1)


def _masked_mean(x, mask, group=None):
    """This rank's share of the mean of x over the global batch's kept
    rows (the batch of the ranks of ``group``)."""
    mask = mask.to(x.dtype)
    return (x * mask).sum() / mesh.all_reduce_sum(
        mask.sum(), group).clamp(min=1.0)


def topk_correct(logits, labels, k):
    """Rows whose label is among the top-k logits. logits (B, C)."""
    topk = logits.topk(k, dim=-1).indices
    return (topk == labels[:, None]).any(dim=-1)


def future_action_terms(logits, tgt_val, mixup_enable, valid,
                        class_weights=None, group=None):
    """Future-action loss and accuracy payload (reference runner.py:54-92).

    logits: (B, T', C) with T' >= 1; tgt_val: (B,) int or (B, C) soft.
    ``class_weights``: optional (C,) per-class loss weights with torch
    ``CrossEntropyLoss(weight=...)`` semantics.
    Returns (loss, acc1, acc5, top-5 ids, labels)."""
    B, Tp, C = logits.shape
    seq = 0
    logits = logits.float()
    if mixup_enable:
        soft_tgt = tgt_val if class_weights is None else \
            tgt_val * class_weights[None, :]
        loss = cross_entropy_one_hot(
            logits.reshape(-1, C), soft_tgt.repeat_interleave(Tp, dim=0))
        loss = loss.reshape(B, Tp)
        # top-2 merge: credit the dominant mixup component with both
        # components' scores (reference :62-74)
        top2 = tgt_val.topk(2, dim=-1).indices
        rows = torch.arange(B, device=logits.device)
        p1 = logits[rows, seq, top2[:, 0]]
        p2 = logits[rows, seq, top2[:, 1]]
        preds = logits.clone()
        preds[rows, seq, top2[:, 0]] = p1 + p2
        # a tensor, not a Python scalar: a scalar would be copied from the
        # host, and on a CUDA device that copy waits for the stream
        preds[rows, seq, top2[:, 1]] = torch.zeros_like(p2)
        labels = top2[:, 0]
    else:
        loss = cross_entropy_index(logits.reshape(-1, C),
                                   tgt_val.repeat_interleave(Tp, dim=0))
        loss = loss.reshape(B, Tp)
        preds = logits
        labels = tgt_val

    flat_valid = valid.repeat_interleave(Tp)
    flat_labels = labels.repeat_interleave(Tp)
    flat_preds = preds.reshape(-1, C)
    acc1 = _masked_mean(topk_correct(flat_preds, flat_labels, 1).float(),
                        flat_valid, group) * 100.0
    acc5 = _masked_mean(
        topk_correct(flat_preds, flat_labels, min(5, C)).float(),
        flat_valid, group) * 100.0
    if class_weights is not None and not mixup_enable:
        # torch weighted mean: sum_i w[y_i] ce_i / sum_i w[y_i]; ignored
        # rows weigh 0 in numerator and denominator
        w = torch.where(tgt_val >= 0, class_weights[tgt_val.clamp(min=0)],
                        torch.zeros((), device=logits.device))
        w = w * valid.float()
        loss = (loss.mean(dim=1) * w).sum() / \
            mesh.all_reduce_sum(w.sum(), group).clamp(min=1e-12)
    else:
        loss = _masked_mean(loss.mean(dim=1), valid, group)
    top5 = preds[:, seq, :].topk(min(5, C), dim=-1).indices
    return loss, acc1, acc5, top5, labels


def past_action_loss(past_logits, past_target, mixup_enable, valid,
                     past_target_ignore_index=None, group=None):
    """Past-frame classification loss (reference runner.py:94-110)."""
    B = past_logits.shape[0]
    C = past_logits.shape[-1]
    if mixup_enable:
        # soft targets with an explicit ignore mask; mean over kept rows
        ce = cross_entropy_one_hot(past_logits.reshape(-1, C),
                                   past_target.reshape(-1, C))
        keep = ~past_target_ignore_index.reshape(-1)
        keep = keep & valid.repeat_interleave(past_logits.shape[1])
        return _masked_mean(ce, keep, group)
    # index targets: zeros at ignored, mean over ALL elements (torch
    # reduction='none' then mean; reference _reduce_loss)
    tgt = past_target.reshape(B, -1)
    ce = cross_entropy_index(past_logits.reshape(-1, C), tgt.reshape(-1))
    return _masked_mean(ce.reshape(B, -1).mean(dim=1), valid, group)


def compute_losses_metrics(outputs: Dict, target: Dict,
                           target_subclips: Optional[Dict], *,
                           mixup_enable: bool = False,
                           target_subclips_ignore_index: Optional[Dict] = None,
                           valid=None, class_weights: Optional[Dict] = None,
                           group=None):
    """BasicLossAccuracy.forward (reference runner.py:112-168).

    ``class_weights`` optionally maps a target name to (C,) per-class
    weights for that target's future-action CE (``cls_*`` terms only).
    Returns (losses, metrics); the mt5r payloads are dicts of device
    tensors (top-5 ids, labels, valid). ``group``: the data ranks whose
    batches make the global batch (the world by default)."""
    losses, metrics = {}, {}
    some_logits = next(iter(outputs[f"logits/{next(iter(target))}"].values()))
    B = some_logits.shape[0]
    if valid is None:
        valid = torch.ones((B,), dtype=torch.bool, device=some_logits.device)

    for tgt_type, tgt_val in target.items():
        cw = None if class_weights is None else class_weights.get(tgt_type)
        for modk, logits in outputs[f"logits/{tgt_type}"].items():
            loss, acc1, acc5, top5, m_labels = future_action_terms(
                logits, tgt_val, mixup_enable, valid, class_weights=cw,
                group=group)
            losses[f"cls_{tgt_type}_{modk}"] = loss
            metrics[f"acc1_{tgt_type}_{modk}"] = acc1
            metrics[f"acc5_{tgt_type}_{modk}"] = acc5
            metrics[f"mt5r_{tgt_type}_{modk}"] = {
                "top5": top5, "labels": m_labels, "valid": valid}

        past_key = f"{PAST_LOGITS_PREFIX}logits/{tgt_type}"
        if past_key in outputs and target_subclips is not None:
            for modk, past_logits in outputs[past_key].items():
                ignore = None if target_subclips_ignore_index is None else \
                    target_subclips_ignore_index[tgt_type]
                losses[f"past_cls_{tgt_type}_{modk}"] = past_action_loss(
                    past_logits, target_subclips[tgt_type], mixup_enable,
                    valid, ignore, group)

    # feature regression, independent of the target
    if "orig_past" in outputs and "past_futures" in outputs:
        for modk, updated in outputs["past_futures"].items():
            if modk not in outputs["orig_past"]:
                continue
            diff = (updated[:, 1:] - outputs["orig_past"][modk][:, 1:]).float()
            per_sample = (diff ** 2).mean(dim=tuple(range(1, diff.dim())))
            losses[f"past_reg_{modk}"] = _masked_mean(per_sample, valid,
                                                      group)

    return losses, metrics


def get_loss_wts(loss_wts: Dict, key: str) -> float:
    """Prefix-matched loss weights (reference runner.py:171-175)."""
    for k, v in loss_wts.items():
        if key.startswith(k):
            return v
    raise ValueError(f"{key} not contained in predefined loss_wts: {loss_wts}")


def reduce_losses(losses: Dict, loss_wts: Dict):
    """Weighted sum of the scalar losses (reference runner.py:198-213)."""
    total = 0.0
    for key, val in losses.items():
        wt = get_loss_wts(loss_wts, key)
        if wt > 0:
            total = total + wt * val
    return total
