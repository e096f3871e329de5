"""Dataset-statistics-driven sampling / loss weighting utilities.

Port of afft_tpu/data/stats.py.

The reference computes per-class sample counts for logging only
(reference datasets/base_video_dataset.py:190-209, mirrored by
FeatureClipDataset._compute_stats_cls_counts). EK100's 3,806 action
classes are heavily long-tailed while the headline metric (MT5R) averages
recall PER CLASS, so these utilities expose the counts as:

- per-sample *sampling* weights (class-balanced resampling with a
  temperature ``alpha``), consumed by BatchLoader(sample_weights=...) /
  ``train.class_balanced_alpha``;
- per-class *loss* weights via the effective-number formulation
  (Cui et al., "Class-Balanced Loss", CVPR 2019).

These are additive capabilities over the reference surface (it ships
neither), kept host-side: the weights feed the epoch index draw or the
loss weighting, nothing about the training step changes shape.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _labels(dataset, target: str) -> np.ndarray:
    col = target + "_class"
    if hasattr(dataset, "datasets"):  # ConcatClipDataset: joint labels
        return np.concatenate([
            np.asarray(d.df[col].values, np.int64)
            for d in dataset.datasets])
    assert col in dataset.df, f"dataset has no {col} column"
    return np.asarray(dataset.df[col].values, np.int64)


def class_counts(dataset, target: str = "action") -> np.ndarray:
    """Dense (n_classes,) per-class sample counts for ``target``.

    Rows labelled -1 (ignore) are excluded. Uses the dataset's annotation
    DataFrame directly — no feature loading.
    """
    n_classes = len(dataset.classes[target])
    labels = _labels(dataset, target)
    counts = np.bincount(labels[labels >= 0], minlength=n_classes)
    return counts[:n_classes].astype(np.int64)


def balanced_sample_weights(dataset, target: str = "action",
                            alpha: float = 1.0) -> np.ndarray:
    """Per-sample sampling weights ~ count(class)^-alpha, sum = 1.

    alpha=0 reproduces uniform sampling; alpha=1 gives every class equal
    expected representation per epoch; intermediate values temper the
    long tail. Samples labelled -1 keep a uniform-share weight.
    """
    counts = class_counts(dataset, target)
    labels = _labels(dataset, target)
    class_w = np.power(np.maximum(counts, 1).astype(np.float64), -alpha)
    # -1-labelled rows sample at the AVERAGE labelled rate (a 1/N weight
    # would effectively exclude them, and would break the alpha=0 ==
    # uniform-sampling contract)
    present = class_w[np.clip(labels, 0, None)][labels >= 0]
    neutral = float(present.mean()) if present.size else 1.0
    w = np.where(labels >= 0, class_w[np.clip(labels, 0, None)], neutral)
    return (w / w.sum()).astype(np.float64)


def effective_number_class_weights(counts: np.ndarray,
                                   beta: float = 0.999) -> np.ndarray:
    """Per-class loss weights (1-beta)/(1-beta^n_c), normalized to mean 1
    over non-empty classes (Cui et al. 2019; empty classes get weight 0)."""
    counts = np.asarray(counts, np.float64)
    eff = 1.0 - np.power(beta, counts)
    w = np.where(counts > 0, (1.0 - beta) / np.maximum(eff, 1e-12), 0.0)
    nz = w[counts > 0]
    if nz.size:
        w = w / nz.mean()
    return w


def summarize(dataset) -> Dict[str, Dict[str, float]]:
    """Human-readable long-tail summary per target (for logs)."""
    out = {}
    for target in dataset.classes:
        try:
            c = class_counts(dataset, target)
        except (AssertionError, KeyError):  # target without a label column
            continue
        nz = c[c > 0]
        out[target] = {
            "classes": int(c.size),
            "classes_with_samples": int(nz.size),
            "median_count": float(np.median(nz)) if nz.size else 0.0,
            "max_count": int(nz.max()) if nz.size else 0,
            "head_10pct_share": float(
                np.sort(nz)[::-1][:max(1, nz.size // 10)].sum() / nz.sum())
            if nz.size else 0.0,
        }
    return out
