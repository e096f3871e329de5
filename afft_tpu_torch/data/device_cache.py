"""Device-resident feature cache: no per-batch host->device traffic.

Port of afft_tpu/data/device_cache.py. Pre-extracted feature datasets are
small next to the card's memory (EK100 val: ~1 GB of bf16 clips; train:
~7 GB), so every planned clip is gathered once through the packed store
(host side, vectorized), the (N, T, F) tensor of each modality is copied to
the device once, and batches become a device-side ``index_select`` driven
by a small index tensor.

Needs the clip plan (deterministic clip strategies) and no host-side
augmentation. There is no fallback: a dataset the cache cannot hold raises.

``dtype="int8"`` halves the cache's bytes against bf16 (port of
afft_tpu/data/device_cache.py:64-134): each frame is quantized
symmetrically, ``q = rint(x / s)`` with ``s = max|x| / 127`` over the
frame's features, the (N, T, F) int8 payload and the fp32 (N, T) scales
both live on the device, and a batch's gather dequantizes there in fp32
before one rounding to bf16. The frames are quantized by the packed
store's own ``PackedFeatureStore._quantize_rows``; an all-zero frame keeps
the payload 0 and so stays exactly zero.
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch

from .loader import shard_indices
from .readers import PackedFeatureStore

log = logging.getLogger(__name__)

CHUNK = 512  # clips gathered on the host per copy while the cache is built


class DeviceFeatureCache:
    """Materialized clips resident on ``device``, indexed per batch there."""

    def __init__(self, dataset, device, dtype=torch.bfloat16):
        self.quantized = dtype in ("int8", torch.int8, np.int8)
        if not getattr(dataset, "supports_batch_load", lambda: False)():
            raise ValueError("data_on_device needs the precomputed clip plan "
                             "(a deterministic sample_strategy and packed "
                             "feature stores)")
        if any(t is not None for t in dataset.transforms.values()):
            raise ValueError("data_on_device cannot apply host-side "
                             "transforms (e.g. ZeroMask); set "
                             "data_train.zero_mask_rate=0")
        self.dataset = dataset
        self.device = torch.device(device)
        plan = dataset._plan
        n = len(dataset)
        # chunks are written into a preallocated tensor: collecting every
        # chunk and concatenating would hold ~2x the cache during the build
        self.features: Dict[str, torch.Tensor] = {}
        # int8 only: {mod: fp32 (N, T)}, kept fp32 beside the payload (bf16
        # scales would add ~0.4% error to every feature)
        self.scales: Dict[str, torch.Tensor] = {}
        store = torch.int8 if self.quantized else dtype
        for mod in dataset.reader_fn:
            feats = scales = None
            for lo in range(0, n, CHUNK):
                idx = np.arange(lo, min(lo + CHUNK, n))
                host = np.asarray(dataset.load_batch(idx)["data_dict"][mod],
                                  np.float32)
                if feats is None:
                    feats = torch.empty((n,) + host.shape[1:], dtype=store,
                                        device=self.device)
                    if self.quantized:
                        scales = torch.empty((n,) + host.shape[1:-1],
                                             dtype=torch.float32,
                                             device=self.device)
                rows = slice(lo, lo + len(idx))
                if self.quantized:
                    q, scale = PackedFeatureStore._quantize_rows(
                        host.reshape(-1, host.shape[-1]))
                    feats[rows] = torch.from_numpy(q.reshape(host.shape)).to(
                        self.device)
                    scales[rows] = torch.from_numpy(
                        scale.reshape(host.shape[:-1])).to(self.device)
                else:
                    feats[rows] = torch.from_numpy(host).to(
                        self.device).to(dtype)
            self.features[mod] = feats
            if self.quantized:
                self.scales[mod] = scales
        self.nbytes = sum(t.numel() * t.element_size() for t in
                          [*self.features.values(), *self.scales.values()])
        log.info("device feature cache: %d clips, %.2f GB on %s%s", n,
                 self.nbytes / 1e9, self.device,
                 " (int8)" if self.quantized else "")

        self.targets = {t: plan["target"][t] for t in dataset.label_type}
        self.labels = plan.get("labels")
        self.uid = np.asarray(plan["uid"])

    def take(self, mod: str, idx: torch.Tensor) -> torch.Tensor:
        """One modality's rows ``idx`` (a device index tensor); int8 rows are
        dequantized in fp32, then rounded once to bf16 (the JAX ``take``,
        :125-134)."""
        rows = self.features[mod].index_select(0, idx)
        if not self.quantized:
            return rows
        scale = self.scales[mod].index_select(0, idx)
        return (rows.float() * scale[..., None]).to(torch.bfloat16)

    def batch(self, indices: np.ndarray) -> Dict:
        """Batch dict with device-side feature gathers (a small index
        upload); targets stay host arrays, as the host loader gives them."""
        indices = np.asarray(indices)
        idx = torch.from_numpy(indices.astype(np.int64))
        if self.device.type == "cuda":
            # pinned: a copy from pageable memory would wait for the stream
            # to drain, and the host could never run ahead of the card
            idx = idx.pin_memory().to(self.device, non_blocking=True)
        batch = {
            "data_dict": {m: self.take(m, idx) for m in self.features},
            "target": {t: v[indices] for t, v in self.targets.items()},
            "uid": self.uid[indices],
            "idx": indices.astype(np.int64),
            "valid": np.ones(len(indices), bool),
        }
        if self.labels is not None:
            batch["target_subclips"] = {
                t: v[indices][:, :, None] for t, v in self.labels.items()}
        return batch

    def iter_batches(self, batch_size: int, shuffle=False, seed=0, epoch=0,
                     shard_id=0, num_shards=1, pad_final=True,
                     sample_weights=None):
        """The host loader's batches (same index order, same padding and
        ``valid`` mask), gathered on the device."""
        indices = shard_indices(len(self.dataset), shuffle, seed, epoch,
                                shard_id, num_shards,
                                weights=sample_weights)
        n_batches = int(np.ceil(len(indices) / batch_size))
        for b in range(n_batches):
            chunk = indices[b * batch_size:(b + 1) * batch_size]
            if pad_final and len(chunk) < batch_size:
                full = np.concatenate(
                    [chunk, np.repeat(chunk[-1:],
                                      batch_size - len(chunk))])
                batch = self.batch(full)
                batch["valid"] = np.arange(batch_size) < len(chunk)
            else:
                batch = self.batch(chunk)
            yield batch
