"""Metric meters and ranking metrics.

Port of afft_tpu/train/metrics.py (reference common/metric_tracking.py:
meters, MetricTracker; common/utils.py:19-86: RULSTM topk_accuracy /
topk_recall, torch accuracy). Meter state lives in numpy on the host, or in
device tensors for the MT5R payloads of a step, read once when the value is
queried. ``synchronize_between_processes`` sums every meter's state over
the processes of a data-parallel run (the reference's dist.all_reduce,
common/metric_tracking.py:31-40; afft_tpu/train/metrics.py:205-211).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..parallel import mesh


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# ranking metrics (numpy, offline evaluation)
# ---------------------------------------------------------------------------

def topk_accuracy(scores: np.ndarray, labels: np.ndarray, ks,
                  selected_class=None):
    """RULSTM top-k accuracy (reference common/utils.py:19-42)."""
    if selected_class is not None:
        idx = labels == selected_class
        scores = scores[idx]
        labels = labels[idx]
    rankings = scores.argsort()[:, ::-1]
    maxk = int(np.max(ks))
    tp = rankings[:, :maxk] == labels.reshape(-1, 1)
    return [tp[:, :k].max(1).mean() for k in ks]


def topk_recall(scores: np.ndarray, labels: np.ndarray, k=5, classes=None):
    """Mean top-k recall over classes (reference common/utils.py:45-56)."""
    unique = np.unique(labels)
    classes = unique if classes is None else np.intersect1d(classes, unique)
    recalls = 0.0
    for c in classes:
        recalls += topk_accuracy(scores, labels, ks=(k,), selected_class=c)[0]
    return recalls / len(classes)


def accuracy(output: np.ndarray, target: np.ndarray, topk=(1,)):
    """Top-k accuracy in percent over flattened leading dims
    (reference common/utils.py:59-86)."""
    if np.all(target < 0):
        return [0.0 for _ in topk]
    output = output.reshape(-1, output.shape[-1])
    target = target.reshape(-1)
    maxk = max(topk)
    # top-maxk indices per row, descending
    pred = np.argsort(-output, axis=1)[:, :maxk]
    correct = pred == target[:, None]
    batch_size = target.shape[0]
    return [correct[:, :k].sum() * (100.0 / batch_size) for k in topk]


# ---------------------------------------------------------------------------
# meters
# ---------------------------------------------------------------------------

class AverageMeter:
    """Running weighted average (reference common/metric_tracking.py:56-88).

    Accepts host floats or device scalars; device values accumulate on the
    device (no per-step readback) and are read once when ``value`` is
    queried."""

    def __init__(self, name, string_format="{:.3f}"):
        self.name = name
        self.string_format = string_format
        self.reset()

    def reset(self):
        self.val, self.sum, self.count = 0.0, 0.0, 0

    def update(self, val, n=1):
        self.val = val
        self.sum = self.sum + val * n
        self.count += n

    def sync_payload(self):
        return np.array([float(self.sum), self.count], np.float64)

    def load_sync(self, arr):
        self.sum, self.count = float(arr[0]), float(arr[1])

    @property
    def value(self):
        return float(self.sum) / self.count if self.count else 0.0

    def to_string(self):
        return self.string_format.format(self.value)


class MeanTopKRecallMeter:
    """Per-class top-k recall averaged over non-empty classes, x100
    (reference common/metric_tracking.py:10-53)."""

    def __init__(self, name, num_classes: int, k=5, string_format="{:.3f}"):
        self.name = name
        self.num_classes = num_classes
        self.k = k
        self.string_format = string_format
        self.reset()

    def reset(self):
        self.tps = np.zeros(self.num_classes)
        self.nums = np.zeros(self.num_classes)

    def update(self, logits_labels_dict: Dict, n=1):
        del n
        if "top5" in logits_labels_dict:
            self._update_device(logits_labels_dict)
            return
        scores = np.asarray(logits_labels_dict["logits"])
        labels = np.asarray(logits_labels_dict["labels"])
        if "valid" in logits_labels_dict:
            valid = np.asarray(logits_labels_dict["valid"])
            scores, labels = scores[valid], labels[valid]
        if len(labels) == 0:
            return
        tp = (np.argsort(scores, axis=1)[:, -self.k:]
              == labels.reshape(-1, 1)).max(1)
        for lbl in np.unique(labels):
            self.tps[lbl] += tp[labels == lbl].sum()
            self.nums[lbl] += (labels == lbl).sum()

    def _update_device(self, payload):
        """Per-class tp/num scatter-adds stay on the payload's device;
        nothing is read back until ``value`` at epoch end."""
        top5 = payload["top5"]
        labels = payload["labels"].reshape(-1)
        valid = payload.get("valid")
        valid = torch.ones(labels.shape, dtype=torch.bool,
                           device=labels.device) if valid is None \
            else valid.reshape(-1)
        tp = (top5[:, :self.k] == labels[:, None]).any(dim=-1) & valid
        # a label of -1 counts for the last class, as numpy's (and JAX's
        # scatter's) negative indexing does in the reference meters
        idx = torch.where(labels < 0, labels + self.num_classes, labels)
        tps, nums = (torch.as_tensor(x, dtype=torch.float64,
                                     device=labels.device)
                     for x in (self.tps, self.nums))
        self.tps = tps.index_add(0, idx, tp.double())
        self.nums = nums.index_add(0, idx, valid.double())

    def sync_payload(self):
        return np.concatenate([_host(self.tps), _host(self.nums)])

    def load_sync(self, arr):
        self.tps = arr[:self.num_classes]
        self.nums = arr[self.num_classes:]

    @property
    def value(self):
        tps, nums = _host(self.tps), _host(self.nums)
        sel = nums > 0
        if not sel.any():
            return None
        return (tps[sel] / nums[sel]).mean() * 100

    def to_string(self):
        v = self.value
        return self.string_format.format(v) if v is not None else "n/a"


class MetricTracker:
    """Tracks named meters; 'mt5r' metrics get recall meters sized from the
    matching target's class count (reference common/metric_tracking.py:91-185).
    ``group``: the processes whose meters ``synchronize_between_processes``
    sums (the world by default; the data group under pipeline parallelism,
    whose stages hold the same meters).
    """

    def __init__(self, num_classes: Dict[str, int], group=None):
        self.training_metrics: Dict = {}
        self.validation_metrics: Dict = {}
        self.num_classes = num_classes
        self.group = group

    def _get_num_classes(self, name):
        num = None
        for key, value in self.num_classes.items():
            if key in name:
                num = value
        if num is None:
            raise ValueError(
                "mt5r metric name must contain a target name: " + name)
        return num

    def _metrics(self, is_training):
        return self.training_metrics if is_training else \
            self.validation_metrics

    def add_metric(self, name, is_training):
        if "mt5r" in name:
            meter = MeanTopKRecallMeter(name, self._get_num_classes(name))
        else:
            meter = AverageMeter(name)
        self._metrics(is_training)[name] = meter

    def update(self, metric_dict: Dict, batch_size: int, is_training: bool):
        metrics = self._metrics(is_training)
        prefix = "train_" if is_training else "val_"
        for key, value in metric_dict.items():
            key = prefix + key
            if key not in metrics:
                self.add_metric(key, is_training)
            metrics[key].update(value, batch_size)

    def synchronize_between_processes(self, is_training):
        """SUM all-reduce of every meter's ``sync_payload`` over the
        processes of ``group``, one all-reduce of their concatenation, in
        name order; nothing to do in one process."""
        if not mesh.active():
            return
        meters = [m for _, m in sorted(self._metrics(is_training).items())]
        payloads = [m.sync_payload() for m in meters]
        flat = torch.from_numpy(np.concatenate(payloads or [np.zeros(0)]))
        summed = mesh.all_reduce_sum(flat, self.group).numpy()
        at = 0
        for meter, payload in zip(meters, payloads):
            meter.load_sync(summed[at:at + len(payload)])
            at += len(payload)

    def reset(self):
        for m in self.training_metrics.values():
            m.reset()
        for m in self.validation_metrics.values():
            m.reset()

    def get_all_data(self, is_training):
        return {k: m.value for k, m in self._metrics(is_training).items()}

    def get_data(self, metric_name, is_training):
        """Meter value, or None when the metric was never produced (the
        loop skips plateau/best-checkpoint logic in that case rather than
        crashing at epoch end on a mistyped primary_metric)."""
        meter = self._metrics(is_training).get(metric_name)
        return None if meter is None else meter.value

    def to_string(self, is_training):
        if is_training:
            result = "\33[0;36;40m" + "Training:    "
        else:
            result = "\33[0;32;40m" + "Validation:  "
        for key, m in self._metrics(is_training).items():
            result += f"{m.name}: {m.to_string()}   "
        return result + "\033[0m"
