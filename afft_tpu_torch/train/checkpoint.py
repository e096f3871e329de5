"""Checkpoint save / load with working resume.

Port of afft_tpu/train/checkpoint.py. A checkpoint is one ``torch.save``
file: the model's state dict in the reference layout (the names and shapes
``weights.load_reference_checkpoint`` and ``serve --weights`` read), the
optimizer's state dict, epoch, step, best metric, the schedule's state
(ReduceLROnPlateau scale / best / patience) and the training randomness, so
a resumed run continues the same streams. Loading restores all of it, so
training actually resumes (the reference never reloads optimizer or epoch).

Writes are atomic (write a sibling, swap by renames; a crash leaves the
previous checkpoint under ``.old-tmp``, which ``load_checkpoint``
recovers) and may run on a background thread (``block=False``): newest
payload per path wins, errors surface on the next save or ``wait``. One
payload saved to several paths (an epoch that is both the best and the
last) is written once; the other paths are hard links to that file, which
a later write of either path replaces without touching the other.
``init_from_model`` merges checkpoints or reference ``.pth`` files into a
state dict by name and shape, optionally filtered by module prefix
(reference train.py:55-103).

Data parallelism: every rank holds the same state, so only rank 0 writes;
``wait_for_pending_saves`` makes the other ranks wait until its files are on
disk. Loading (``init_from_model``, resume) runs on every rank.
"""

from __future__ import annotations

import logging
import os
import threading
from pathlib import Path
from typing import Dict, List, Optional

import torch

from ..parallel import mesh
from ..weights import load_reference_checkpoint

CKPT_BEST_DIRNAME = "checkpoint_best"
CKPT_LAST_DIRNAME = "checkpoint_last"

# Layout version of the port's checkpoints: 1 = reference-layout state dict
# (HF Conv1D c_attn packed [q | k | v]). A file of another version would load
# into the wrong layout, so load_checkpoint refuses it.
CKPT_FORMAT_VERSION = 1

_OLD_SUFFIX = ".old-tmp"
_NEW_SUFFIX = ".new-tmp"


def _swap_in(path: Path, fill, epoch, how=""):
    """``fill(<path>.new-tmp)``, then swap it in by renames, so a complete
    checkpoint is on disk at every instant; a crash between the two renames
    leaves it under ``<path>.old-tmp``, which load_checkpoint recovers
    (afft_tpu/train/checkpoint.py:43-68)."""
    new_tmp = path.with_name(path.name + _NEW_SUFFIX)
    old_tmp = path.with_name(path.name + _OLD_SUFFIX)
    path.parent.mkdir(parents=True, exist_ok=True)
    if new_tmp.exists():  # a stale one from a crash
        new_tmp.unlink()
    fill(new_tmp)
    if old_tmp.exists():
        old_tmp.unlink()
    if path.exists():
        path.rename(old_tmp)
    new_tmp.rename(path)
    if old_tmp.exists():
        old_tmp.unlink()
    logging.info("Stored checkpoint at epoch %s to %s%s", epoch, path, how)


def _write_and_swap(path: Path, payload: dict, epoch):
    """Write ``payload`` to ``path`` atomically."""
    def fill(tmp):
        with open(tmp, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
    _swap_in(path, fill, epoch)


def _save_to(paths, payload: dict, epoch):
    """``payload`` to ``paths[0]``; each further path swaps in a hard link
    to that file."""
    _write_and_swap(paths[0], payload, epoch)
    for path in paths[1:]:
        _swap_in(path, lambda tmp: os.link(paths[0], tmp), epoch,
                 " (a hard link)")


class _AsyncSaver:
    """One background writer; the newest payload per path wins
    (afft_tpu/train/checkpoint.py:71-147). Queued host memory is bounded by
    one payload per distinct checkpoint name."""

    def __init__(self):
        self._cv = threading.Condition()
        # keyed by the tuple of paths one payload goes to
        self._pending: Dict[tuple, tuple] = {}
        self._order: List[tuple] = []
        self._thread = None
        self._last_thread = None  # the newest worker, joined by wait()
        self._busy = False
        self._errors: List = []  # every failed (path, exc), not just first

    def submit(self, paths: tuple, payload: dict, epoch):
        with self._cv:
            # queue before surfacing an earlier failure: a stale error must
            # never drop the caller's new payload. A path is in at most one
            # queued entry: the new payload takes its paths out of older
            # entries, which keep their other paths
            for key in list(self._order):
                rest = tuple(p for p in key if p not in paths)
                if rest != key:
                    queued = self._pending.pop(key)
                    at = self._order.index(key)
                    if rest:
                        self._order[at] = rest
                        self._pending[rest] = queued
                    else:
                        del self._order[at]
            self._order.append(paths)
            self._pending[paths] = (payload, epoch)
            if self._thread is None:
                # liveness is this attribute, changed only under the lock
                # (the worker clears it in its exit decision)
                self._thread = threading.Thread(target=self._run,
                                                name="ckpt-writer",
                                                daemon=True)
                self._last_thread = self._thread
                self._thread.start()
            self._cv.notify_all()
            self._raise_pending_error()

    def _run(self):
        while True:
            with self._cv:
                if not self._order:
                    self._busy = False
                    self._thread = None
                    self._cv.notify_all()
                    return
                paths = self._order.pop(0)
                payload, epoch = self._pending.pop(paths)
                self._busy = True
            try:
                _save_to(paths, payload, epoch)
            except BaseException as e:  # surfaced on next submit()/wait()
                with self._cv:
                    self._errors.append((", ".join(map(str, paths)), e))
                # keep draining: saves to other paths are still attempted
            finally:
                # the payload's host copies are freed before this thread can
                # report itself idle
                del payload

    def wait(self):
        """Until every queued payload is on disk and the writer thread has
        ended: a process may exit right after (a thread still running
        through tensor destructors while the interpreter shuts down aborts
        it)."""
        with self._cv:
            self._cv.wait_for(lambda: not self._order and not self._busy)
            worker = self._last_thread
        if worker is not None and worker is not threading.current_thread():
            worker.join()
        with self._cv:
            self._raise_pending_error()

    def has_pending(self) -> bool:
        with self._cv:
            return bool(self._order) or self._busy

    def _raise_pending_error(self):
        if self._errors:
            errs, self._errors = self._errors, []
            detail = "; ".join(f"{p}: {e!r}" for p, e in errs)
            raise RuntimeError(
                f"async checkpoint save failed ({detail})") from errs[0][1]


_ASYNC_SAVER = _AsyncSaver()


def wait_for_pending_saves():
    """Block until every async checkpoint write is on disk (call at the end
    of training, on every rank: the others wait for rank 0's writes);
    re-raises any writer failure."""
    try:
        _ASYNC_SAVER.wait()
    finally:
        mesh.barrier()


def to_host(tree):
    """A copy of a nested dict / list of tensors on the host, detached from
    the device buffers the next step will overwrite."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def save_checkpoint(path, model_state: Dict, optimizer_state: Dict,
                    epoch: int, step: int, best_metric: float,
                    schedule_state: Optional[dict] = None,
                    rng_state: Optional[dict] = None, block: bool = True):
    """Save a checkpoint to ``path``, or to each of a list of paths (written
    once, the others hard links). Host copies are taken here, so the
    caller's tensors may change right after. ``block=False`` hands the disk
    write to the background writer; call :func:`wait_for_pending_saves`
    before exiting. In a data-parallel run ranks other than 0 write
    nothing."""
    if mesh.rank_and_world()[0] != 0:
        return
    payload = {
        "model": to_host(model_state),
        "optimizer": to_host(optimizer_state),
        "epoch": int(epoch),
        "step": int(step),
        "best_metric": float(best_metric),
        "format_version": CKPT_FORMAT_VERSION,
    }
    if schedule_state:
        payload["schedule"] = dict(schedule_state)
    if rng_state is not None:
        payload["rng"] = to_host(rng_state)
    paths = tuple(Path(p).absolute() for p in (
        path if isinstance(path, (list, tuple)) else [path]))
    if block and not _ASYNC_SAVER.has_pending():
        _save_to(paths, payload, epoch)
    elif block:
        # a background save may be writing these very paths: go through the
        # one writer thread (serialized, newest wins) and wait
        _ASYNC_SAVER.submit(paths, payload, epoch)
        _ASYNC_SAVER.wait()
    else:
        _ASYNC_SAVER.submit(paths, payload, epoch)


def load_checkpoint(path) -> Dict:
    """A checkpoint written by save_checkpoint, on the CPU."""
    path = Path(path).absolute()
    if not path.exists():
        old_tmp = path.with_name(path.name + _OLD_SUFFIX)
        if old_tmp.exists():
            # crash between the two swap renames: the previous complete
            # checkpoint survives under .old-tmp
            logging.warning("Recovering checkpoint from %s", old_tmp)
            old_tmp.rename(path)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    version = ckpt.get("format_version") if isinstance(ckpt, dict) else None
    if version != CKPT_FORMAT_VERSION:
        raise ValueError(
            f"{path} is not a checkpoint of this layout (format_version "
            f"{version}, expected {CKPT_FORMAT_VERSION}); a reference .pth "
            "loads through init_from_model or weights."
            "load_reference_checkpoint")
    return ckpt


def merge_matching(model_state: Dict, loaded: Dict,
                   modules_to_keep: Optional[List[str]] = None, logger=None):
    """Copy of ``model_state`` with the loaded tensors whose names exist and
    whose shapes match (reference init_model semantics, train.py:55-103);
    ``modules_to_keep`` keeps only names with one of those prefixes.
    Returns (merged state, names used)."""
    logger = logger or logging.getLogger(__name__)
    if modules_to_keep:
        if not isinstance(modules_to_keep, (list, tuple)):
            modules_to_keep = [modules_to_keep]
        loaded = {k: v for k, v in loaded.items()
                  if any(k.startswith(m) for m in modules_to_keep)}
    merged = dict(model_state)
    used, skipped = [], []
    for k, v in loaded.items():
        if k in merged and tuple(v.shape) == tuple(merged[k].shape):
            merged[k] = v
            used.append(k)
        else:
            skipped.append(k)
    missing = [k for k in model_state if k not in loaded]
    if skipped:
        logger.warning("Skipped %d ckpt keys (missing/shape mismatch): %s...",
                       len(skipped), skipped[:5])
    if missing:
        logger.warning("Model keys not in ckpt: %d (e.g. %s)",
                       len(missing), missing[:5])
    return merged, used


def init_from_model(model_state: Dict, ckpt_paths, modules_to_keep=None,
                    logger=None):
    """``model_state`` (a state dict) with the tensors of one or more
    checkpoints merged in, in order (reference train.py:64-75): the port's
    checkpoints, or reference ``.pth`` / ``.pt`` files through
    ``weights.load_reference_checkpoint``. Returns (state, names used)."""
    logger = logger or logging.getLogger(__name__)
    if not isinstance(ckpt_paths, (list, tuple)):
        ckpt_paths = [ckpt_paths]
    used_all = []
    for path in ckpt_paths:
        path = str(path)
        if path.endswith((".pth", ".pt")):
            loaded = load_reference_checkpoint(path)
        else:
            loaded = load_checkpoint(path)["model"]
        model_state, used = merge_matching(model_state, loaded,
                                           modules_to_keep, logger)
        used_all += used
        logger.info("Initialized %d tensors from %s", len(used), path)
    return model_state, used_all
