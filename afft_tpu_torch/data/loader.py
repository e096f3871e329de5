"""Batched host-side data loader.

Port of afft_tpu/data/loader.py (reference train.py:106-153, torch
DataLoader + DistributedSampler): a thread-pooled, prefetching batch loader
producing fixed-shape numpy batches, which ``Runner`` copies to the card
from pinned memory. Per-process sharding replicates DistributedSampler
semantics (wrap-around padding to equal shards, per-epoch seeded shuffle via
``set_epoch``-style epoch keys): each process of a data-parallel run
(``parallel.mesh``) loads its own shard.

Fixed shapes: the final partial batch is padded and carries a ``valid`` mask
that the losses and metrics honour, so every batch of an epoch has one shape.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np


def shard_indices(n: int, shuffle: bool, seed: int, epoch: int,
                  shard_id: int = 0, num_shards: int = 1,
                  weights: Optional[np.ndarray] = None) -> np.ndarray:
    """torch DistributedSampler-equivalent index selection.

    ``weights`` (len n, summing to 1) switches the epoch draw to weighted
    sampling WITH replacement (class-balanced resampling, see
    afft_tpu_torch.data.stats) — epoch length stays n, sharding is unchanged.
    """
    if weights is not None:
        assert shuffle, "weighted sampling implies shuffle"
        g = np.random.default_rng(seed + epoch)
        indices = g.choice(n, size=n, replace=True, p=weights)
    elif shuffle:
        g = np.random.default_rng(seed + epoch)
        indices = g.permutation(n)
    else:
        indices = np.arange(n)
    if num_shards == 1:
        return indices
    total = int(np.ceil(n / num_shards)) * num_shards
    if total > n:  # wrap-around padding, like DistributedSampler —
        # REPEATING the sequence until the target length (a single
        # indices[:total-n] slice under-fills when n < total - n, leaving
        # some shards empty: empty per-rank eval shards / diverging batch
        # counts deadlock the lockstep collectives)
        reps = int(np.ceil(total / max(n, 1)))
        indices = np.tile(indices, reps)[:total]
    return indices[shard_id::num_shards]


def collate(items) -> Dict:
    """Stack per-item dicts into fixed-shape arrays."""
    batch = {
        "data_dict": {
            mod: np.stack([it["data_dict"][mod] for it in items])
            for mod in items[0]["data_dict"]
        },
        "target": {
            t: np.asarray([it["target"][t] for it in items], np.int64)
            for t in items[0]["target"]
        },
        "uid": np.asarray([it["uid"] for it in items]),
        "idx": np.asarray([it["idx"] for it in items], np.int64),
    }
    if "target_subclips" in items[0]:
        batch["target_subclips"] = {
            t: np.stack([it["target_subclips"][t] for it in items])
            for t in items[0]["target_subclips"]
        }
    return batch


def _pad_batch(batch: Dict, to_size: int) -> Dict:
    """Pad a partial batch to ``to_size`` by repeating the last item; adds a
    ``valid`` mask so padded rows are excluded from losses/metrics."""
    cur = len(batch["idx"])
    valid = np.zeros((to_size,), bool)
    valid[:cur] = True

    def pad(x):
        if cur == to_size:
            return x
        reps = [x[-1:]] * (to_size - cur)
        return np.concatenate([x] + reps, axis=0)

    out = {
        "data_dict": {m: pad(v) for m, v in batch["data_dict"].items()},
        "target": {t: pad(v) for t, v in batch["target"].items()},
        "uid": pad(batch["uid"]),
        "idx": pad(batch["idx"]),
        "valid": valid,
    }
    if "target_subclips" in batch:
        out["target_subclips"] = {
            t: pad(v) for t, v in batch["target_subclips"].items()}
    return out


def pin_batch(batch: Dict) -> Dict:
    """The batch's arrays as tensors in page-locked host memory, from which
    the copy to a card neither blocks the host nor waits for the stream;
    ``uid`` and ``idx`` stay numpy."""
    import torch

    def pin(x):
        return torch.from_numpy(np.ascontiguousarray(x)).pin_memory()
    out = dict(batch)
    for key in ("data_dict", "target", "target_subclips"):
        if key in batch:
            out[key] = {k: pin(v) for k, v in batch[key].items()}
    out["valid"] = pin(batch["valid"])
    return out


class BatchLoader:
    """Thread-pooled prefetching loader over a FeatureClipDataset.
    ``pin_memory`` hands out batches in page-locked memory (``pin_batch``),
    pinned on the loader's producer thread, off the training loop's."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 42, num_workers: int = 8, shard_id: int = 0,
                 num_shards: int = 1, drop_last: bool = False,
                 pad_final: bool = True, prefetch: int = 3,
                 sample_weights: Optional[np.ndarray] = None,
                 pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.sample_weights = sample_weights
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.drop_last = drop_last
        self.pad_final = pad_final
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self):
        n = len(shard_indices(len(self.dataset), False, 0, 0,
                              self.shard_id, self.num_shards))
        if self.drop_last:
            return n // self.batch_size
        return int(np.ceil(n / self.batch_size))

    def __iter__(self) -> Iterator[Dict]:
        indices = shard_indices(len(self.dataset), self.shuffle, self.seed,
                                self._epoch, self.shard_id, self.num_shards,
                                weights=self.sample_weights)
        n_batches = len(self)
        # maxsize 0 would mean UNBOUNDED for queue.Queue; clamp so the
        # constant-memory guarantee holds even at prefetch=0
        out_q: "queue.Queue" = queue.Queue(maxsize=max(1, self.prefetch))
        stop = threading.Event()

        batch_load = getattr(self.dataset, "supports_batch_load",
                             lambda: False)()

        def make_batch(chunk):
            if batch_load:
                return self.dataset.load_batch(chunk)
            return collate([self.dataset.get_item(i) for i in chunk])

        def put_with_stop(item) -> bool:
            """Bounded put that never deadlocks: gives up when the consumer
            abandoned the iterator (stop set)."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            # bounded-lookahead pipeline: at most prefetch+2 batches in
            # flight, so memory stays constant on arbitrarily long epochs
            chunks = [indices[b * self.batch_size:(b + 1) * self.batch_size]
                      for b in range(n_batches)]
            inflight = []
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    next_i = 0
                    while (inflight or next_i < len(chunks)) \
                            and not stop.is_set():
                        while next_i < len(chunks) and \
                                len(inflight) < self.prefetch + 2:
                            inflight.append(
                                (pool.submit(make_batch, chunks[next_i]),
                                 chunks[next_i]))
                            next_i += 1
                        fut, chunk = inflight.pop(0)
                        batch = fut.result()
                        if self.pad_final:
                            batch = _pad_batch(batch, self.batch_size)
                        else:
                            batch["valid"] = np.ones(len(chunk), bool)
                        if self.pin_memory:
                            batch = pin_batch(batch)
                        if not put_with_stop(batch):
                            return
                put_with_stop(None)
            except BaseException as e:  # surface loader errors, don't hang
                put_with_stop(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()


def get_dataset(dataset_cfg, data_cfg, transforms, logger=None):
    """Dataset factory, reference datasets/data.py:4-17."""
    from ..config.registry import instantiate
    kwargs = {
        "transforms": transforms,
        "frame_rate": data_cfg["frame_rate"],
        "frames_per_clip": data_cfg["num_frames"],
        "frame_subclips_options": dict(data_cfg["frame_subclips"].items()),
        "sec_subclips_options": dict(data_cfg["sec_subclips"].items()),
        "load_seg_labels": data_cfg["load_seg_labels"],
    }
    return instantiate(dataset_cfg, _recursive_=False, **kwargs)
