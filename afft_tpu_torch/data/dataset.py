"""Clip dataset over pre-extracted features.

Port of afft_tpu/data/dataset.py. Behavioural reference: datasets/base_video_dataset.py:94-487 in the upstream
repo. Keeps the reference's sampling semantics exactly (clip strategies,
fps subsampling back-aligned for last_clip, front padding, per-frame past
labels including the closest-row tie-break) but restructured for host
throughput: features are fetched with one vectorized store gather per clip,
and per-frame segmentation labels use a precomputed per-video interval table
instead of a pandas scan per item (reference :431-458 is the slow path).
"""

from __future__ import annotations

import logging
import random as pyrandom
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import pandas as pd

from pathlib import Path

from .anticipation import RULSTM_TSN_FPS, convert_to_anticipation
from ..config.registry import instantiate

SAMPLE_STRAT_CNTR = "center_clip"
SAMPLE_STRAT_RAND = "random_clip"
SAMPLE_STRAT_FIRST = "first_clip"
SAMPLE_STRAT_LAST = "last_clip"


class ZeroMaskFeats:
    """Random frame zero-masking augmentation
    (reference common/transforms.py:13-25)."""

    def __init__(self, mask_rate=0.2):
        self.mask_rate = mask_rate

    def __call__(self, feats: np.ndarray) -> np.ndarray:
        if self.mask_rate == 0:
            return feats
        num_frames = feats.shape[0]
        num_masked = round(num_frames * self.mask_rate)
        rows = pyrandom.sample(range(num_frames), num_masked)
        feats = feats.copy()
        feats[rows] = 0.0
        return feats


class _VideoLabelIndex:
    """Per-video interval table for past-frame labels
    (replaces the per-item pandas scan, reference :431-458)."""

    def __init__(self, df: pd.DataFrame, label_types: Sequence[str]):
        assert "orig_start" in df, \
            "load_seg_labels requires conv_to_anticipate_fn (per-frame " \
            "past labels index the ORIGINAL action extents, which only " \
            "convert_to_anticipation records as orig_start/orig_end)"
        self.by_video = {}
        for video, vdf in df.groupby("video_path", sort=False):
            entry = {
                "orig_start": vdf.orig_start.values.astype(np.float64),
                "orig_end": vdf.orig_end.values.astype(np.float64),
            }
            for tname in label_types:
                col = tname + "_class"
                entry[tname] = (vdf[col].values.astype(np.int64)
                                if col in vdf else
                                np.full(len(vdf), -1, np.int64))
            self.by_video[str(video)] = entry

    def labels_at(self, video: str, times: np.ndarray,
                  label_types: Sequence[str]) -> Dict[str, np.ndarray]:
        entry = self.by_video.get(str(video))
        out = {t: np.full(len(times), -1, np.int64) for t in label_types}
        if entry is None:
            return out
        os_, oe = entry["orig_start"], entry["orig_end"]
        hits = (times[:, None] >= os_[None]) & (times[:, None] <= oe[None])
        any_hit = hits.any(axis=1)
        if not any_hit.any():
            return out
        # ties: reference picks argmin |t - (end-start)/2| over matching rows
        # (datasets/base_video_dataset.py:450-453; note this is half-duration,
        # not the segment centre — replicated bug-for-bug)
        half_dur = (oe - os_) / 2.0
        score = np.abs(times[:, None] - half_dur[None])
        score = np.where(hits, score, np.inf)
        best = np.argmin(score, axis=1)
        for tname in label_types:
            vals = entry[tname][best]
            out[tname] = np.where(any_hit, vals, -1)
        return out


class FeatureClipDataset:
    """Anticipation clips over per-frame feature stores.

    Item layout (native): data {mod: (T, F) float32}, target {type: int},
    target_subclips {type: (T, 1) int}, video_frame_sec (T,), uid, idx.
    """

    def __init__(self,
                 df: pd.DataFrame,
                 frames_per_clip: int = 10,
                 frame_rate: Optional[float] = None,
                 frame_subclips_options: Optional[Dict] = None,
                 sec_subclips_options: Optional[Dict] = None,
                 load_seg_labels: bool = False,
                 reader_fn: Optional[Dict] = None,
                 transforms: Optional[Dict] = None,
                 label_type: Union[str, Sequence[str]] = "action",
                 sample_strategy: str = SAMPLE_STRAT_LAST,
                 conv_to_anticipate_fn: Optional[Dict] = None,
                 random_seed: int = 42,
                 verb_classes: Optional[dict] = None,
                 noun_classes: Optional[dict] = None,
                 action_classes: Optional[dict] = None,
                 dummy_label: Union[list, int] = -1,
                 compute_dataset_stats: bool = False,
                 max_els: Optional[int] = None,
                 data_dir_train=None, data_dir_test=None,
                 data_dir_extension=None,
                 **_ignored):
        self.df = df
        if "uid" not in self.df.columns:
            self.df = self.df.copy()
            self.df.loc[:, "uid"] = range(1, len(self.df) + 1)

        self.discarded_df = None
        self.challenge_type = "action_recognition"
        if conv_to_anticipate_fn is not None:
            self.df, self.discarded_df = instantiate(conv_to_anticipate_fn,
                                                     self.df)
            logging.info("Discarded %d elements in anticipate conversion",
                         len(self.discarded_df))
            self.challenge_type = "action_anticipation"

        self.frames_per_clip = frames_per_clip
        self.frame_rate = frame_rate
        assert sample_strategy in (SAMPLE_STRAT_CNTR, SAMPLE_STRAT_RAND,
                                   SAMPLE_STRAT_FIRST, SAMPLE_STRAT_LAST), \
            f"unknown sample_strategy {sample_strategy!r}"
        self.sample_strategy = sample_strategy
        self.label_type = ([label_type] if isinstance(label_type, str)
                           else list(label_type))
        self.load_seg_labels = load_seg_labels
        self.verb_classes = verb_classes or {}
        self.noun_classes = noun_classes or {}
        self.action_classes = action_classes or {}
        self.dummy_label = dummy_label
        self.random_seed = random_seed
        self._epoch = 0  # set_epoch folds into the random_clip window draw
        self.rng = np.random.default_rng(random_seed)
        self.frame_subclips_options = dict(frame_subclips_options or
                                           {"num_frames": 1, "stride": 1})
        self.sec_subclips_options = dict(sec_subclips_options or
                                         {"num_frames": 1, "stride": 1})
        # num_frames/stride != 1 -> sliding-window temporal re-expansion
        # (reference _get_subclips, base_video_dataset.py:401-415 + the
        # flatten at base_model.py:44-45). Served by the per-item path; the
        # vectorized clip plan covers the {1,1} case of every shipped config.
        self._default_subclips = (
            self.frame_subclips_options == {"num_frames": 1, "stride": 1}
            and self.sec_subclips_options == {"num_frames": 1, "stride": 1})

        # readers: {mod: EpicRULSTMFeatsReader-like}; dict configs are
        # instantiated through the registry (reference reader_fn TargetConf)
        self.reader_fn = {}
        for mod, rf in (reader_fn or {}).items():
            if isinstance(rf, dict) and "_target_" in rf:
                rf = instantiate(rf)
            self.reader_fn[mod] = rf

        self.df_before_subset = self.df
        if max_els is not None:
            # seeded: every process must draw the IDENTICAL subset (the
            # sharded loaders assume one global index order), and runs must
            # be reproducible
            self.df = self.df.sample(n=max_els, replace=False,
                                     random_state=random_seed)
            self.df = self.df.reset_index(drop=True)

        self.transforms = transforms or {}
        self._label_index = _VideoLabelIndex(self.df_before_subset,
                                             self.label_type) \
            if load_seg_labels else None

        if compute_dataset_stats:
            self.classes_counts = self._compute_stats_cls_counts()
            logging.debug("classes counts: %s", self.classes_counts)

        # hot-path plan: precompute every clip's frame ids / timestamps /
        # past labels once, so get_item is a vectorized store gather (the
        # reference recomputes window math and scans pandas per item — its
        # input pipeline bottleneck, SURVEY §7 hard parts)
        self._plan = None
        if self._default_subclips:
            try:
                self._plan = self._build_plan()
            except Exception as e:  # raw-video readers, exotic configs
                logging.info("clip-plan disabled (%s); using per-item path", e)

    def _compute_stats_cls_counts(self):
        """Per-class sample counts incl. the -1 bucket
        (reference base_video_dataset.py:190-209)."""
        all_counts = {}
        for tname, tclasses in self.classes.items():
            col = tname + "_class"
            if col not in self.df:
                logging.warning("No %s column for dataset stats", col)
                continue
            lbls = np.asarray(self.df[col].values)
            counts = {cls_id: int((lbls == cls_id).sum())
                      for cls_id in [-1] + list(tclasses.values())}
            assert sum(counts.values()) == len(self.df)
            all_counts[tname] = counts
        return all_counts

    # ------------------------------------------------------------------
    @property
    def classes(self) -> OrderedDict:
        return OrderedDict(
            (t, getattr(self, t + "_classes")) for t in self.label_type)

    @property
    def classes_manyshot(self) -> OrderedDict:
        return self.classes

    @property
    def class_mappings(self) -> Dict:
        return {}

    def __len__(self):
        return len(self.df)

    # ------------------------------------------------------------------
    def _build_plan(self):
        """Precompute (N, frames_per_clip) frame-id/timestamp tables plus
        past-frame labels for deterministic clip strategies. Replicates the
        per-item arithmetic of the reference exactly — padding with a
        repeated first/last frame id yields identical features, since reads
        are pure functions of the id."""
        if self.sample_strategy == SAMPLE_STRAT_RAND or not self.reader_fn:
            return None
        readers = list(self.reader_fn.values())
        if not all(hasattr(r, "read_ids") for r in readers):
            return None
        fps_set = {r.get_frame_rate(None) for r in readers}
        if len(fps_set) != 1:
            return None
        fps = float(fps_set.pop())
        req = self.frame_rate if self.frame_rate is not None else fps
        fpc = self.frames_per_clip
        fte = int(round(fpc * (fps / req)))
        step = max(int(round(fps / req)), 1)
        is_last = self.sample_strategy == SAMPLE_STRAT_LAST

        starts = np.maximum(self.df.start.values.astype(np.float64), 0.0)
        ends = np.maximum(self.df.end.values.astype(np.float64), 0.0)
        nframes = (fps * (ends - starts)).astype(np.int64)
        if self.sample_strategy == SAMPLE_STRAT_LAST:
            start_frames = np.maximum(nframes - fte, 0)
        elif self.sample_strategy == SAMPLE_STRAT_CNTR:
            start_frames = np.maximum((nframes - fte) // 2, 0)
        else:  # first_clip
            start_frames = np.zeros_like(nframes)
        new_starts = starts + start_frames / fps
        new_ends = np.maximum(np.minimum(ends, starts +
                                         (start_frames + fte) / fps), 0.0)
        new_starts = np.minimum(np.maximum(new_starts, 0.0), new_ends)
        start_fs = np.floor(new_starts * fps).astype(np.int64)
        end_fs = np.floor(new_ends * fps).astype(np.int64)

        N = len(self.df)
        keep_cache = {}
        frame_ids = np.zeros((N, fpc), np.int64)
        frame_sec = np.zeros((N, fpc), np.float32)
        for i in range(N):
            count = int(end_fs[i] - start_fs[i])
            if count <= 0:
                raise ValueError("empty clip window")
            keep = keep_cache.get(count)
            if keep is None:
                keep = (np.arange(count)[::-step][::-1] if is_last
                        else np.arange(count)[::step])
                keep_cache[count] = keep
            ids = np.arange(start_fs[i] + 1, end_fs[i] + 1)
            if ids.max() < 1:
                raise ValueError("window fully before video start")
            ids[ids < 1] = ids[ids >= 1].min()
            if new_starts[i] >= new_ends[i]:
                sec = np.full(count, new_starts[i], np.float32)
            else:
                sec = np.linspace(new_starts[i], new_ends[i], count,
                                  dtype=np.float32)
            ids, sec = ids[keep], sec[keep]
            t = len(ids)
            if t < fpc:
                npad = fpc - t
                if is_last:
                    ids = np.concatenate([np.repeat(ids[:1], npad), ids])
                    sec = np.concatenate([np.repeat(sec[:1], npad), sec])
                else:
                    ids = np.concatenate([ids, np.repeat(ids[-1:], npad)])
                    sec = np.concatenate([sec, np.repeat(sec[-1:], npad)])
            frame_ids[i] = ids[-fpc:] if is_last else ids[:fpc]
            frame_sec[i] = sec[-fpc:] if is_last else sec[:fpc]

        plan = {
            "fps": fps,
            "frame_ids": frame_ids,
            "frame_sec": frame_sec,
            # numpy up front: load_batch gathers index these per batch
            "video": np.asarray(
                [str(Path(v).stem) for v in self.df.video_path.values],
                dtype=object),
            "uid": np.asarray(self.df.uid.values),
            "target": {
                t: (self.df[t + "_class"].values.astype(np.int64)
                    if t + "_class" in self.df else
                    np.full(N, self.dummy_label, np.int64))
                for t in self.label_type},
            "start": self.df.start.values,
            "end": self.df.end.values,
        }
        if self.load_seg_labels:
            labels = {t: np.full((N, fpc), -1, np.int64)
                      for t in self.label_type}
            videos = self.df.video_path.values
            for i in range(N):
                row_labels = self._label_index.labels_at(
                    videos[i], frame_sec[i].astype(np.float64),
                    self.label_type)
                for t in self.label_type:
                    labels[t][i] = row_labels[t]
            plan["labels"] = labels
        return plan

    def supports_batch_load(self) -> bool:
        return (self._plan is not None
                and all(getattr(r, "supports_batch", lambda: False)()
                        for r in self.reader_fn.values()))

    def load_batch(self, indices) -> Dict:
        """Whole-batch fast path: one vectorized store gather per modality —
        no per-item Python, no collate. Produces the same batch dict as
        collate([get_item(i) for i in indices])."""
        p = self._plan
        indices = np.asarray(indices)
        videos = p["video"][indices]
        ids = p["frame_ids"][indices]
        data = {}
        for mod, reader in self.reader_fn.items():
            feats = reader.read_ids_batch(videos, ids, p["fps"])
            if feats.dtype == np.float64:
                feats = feats.astype(np.float32)
            tfm = self.transforms.get(mod)
            if tfm is not None:
                # host-side transforms compute in fp32: numpy emulates
                # bf16 arithmetic in software (the bf16 staging fast path
                # only applies to the transform-free serving pipeline)
                if feats.dtype not in (np.float32, np.float64):
                    feats = feats.astype(np.float32)
                feats = np.stack([tfm(f) for f in feats])
            data[mod] = feats
        batch = {
            "data_dict": data,
            "target": {t: p["target"][t][indices]
                       for t in self.label_type},
            "uid": p["uid"][indices],
            "idx": indices.astype(np.int64),
        }
        if self.load_seg_labels:
            batch["target_subclips"] = {
                t: p["labels"][t][indices][:, :, None]
                for t in self.label_type}
        return batch

    def _get_item_fast(self, idx: int) -> Dict:
        p = self._plan
        video = p["video"][idx]
        ids = p["frame_ids"][idx]
        data = {}
        for mod, reader in self.reader_fn.items():
            feats = reader.read_ids(video, ids, p["fps"])
            if feats.dtype == np.float64:
                feats = feats.astype(np.float32)
            tfm = self.transforms.get(mod)
            if tfm is not None:
                if feats.dtype not in (np.float32, np.float64):
                    feats = feats.astype(np.float32)  # see load_batch
                feats = tfm(feats)
            data[mod] = feats
        item = {
            "data_dict": data,
            "target": OrderedDict((t, int(p["target"][t][idx]))
                                  for t in self.label_type),
            "uid": p["uid"][idx],
            "idx": idx,
            "video_frame_sec": p["frame_sec"][idx],
            "start": p["start"][idx],
            "end": p["end"][idx],
        }
        if self.load_seg_labels:
            item["target_subclips"] = {
                t: p["labels"][t][idx][:, None] for t in self.label_type}
        return item

    def _clip_window(self, start: float, end: float, fps: float,
                     idx: int = 0):
        """Clip selection arithmetic (reference :225-263)."""
        start, end = max(start, 0.0), max(end, 0.0)
        req_fps = self.frame_rate if self.frame_rate is not None else fps
        nframes = int(fps * (end - start))
        frames_to_ext = int(round(self.frames_per_clip * (fps / req_fps)))

        strat = self.sample_strategy
        if strat == SAMPLE_STRAT_RAND:
            start_frame = max(nframes - frames_to_ext, 0)
            if start_frame > 0:
                # per-item generator: loader worker THREADS call get_item
                # concurrently, and a shared np.Generator is neither
                # thread-safe nor schedule-independent; seeding by
                # (dataset seed, epoch, row) is both, at equal distribution,
                # and the epoch component keeps the per-epoch window draw
                # varying like the reference's per-access draw
                g = np.random.default_rng(
                    (self.random_seed, self._epoch, int(idx)))
                start_frame = int(g.integers(start_frame))
        elif strat == SAMPLE_STRAT_CNTR:
            start_frame = max((nframes - frames_to_ext) // 2, 0)
        elif strat == SAMPLE_STRAT_LAST:
            start_frame = max(nframes - frames_to_ext, 0)
        elif strat == SAMPLE_STRAT_FIRST:
            start_frame = 0
        else:
            raise NotImplementedError(f"Unknown {strat}")

        new_start = start + max(start_frame / fps, 0)
        new_end = start + max((start_frame + frames_to_ext) / fps, 0)
        new_end = max(min(end, new_end), 0)
        new_start = min(max(new_start, 0), new_end)
        return new_start, new_end, req_fps

    def _subsample_and_pad(self, feats: np.ndarray, frame_sec: np.ndarray,
                           fps: float, req_fps: float, idx=0):
        """fps subsampling (back-aligned for last/random) + front padding
        (reference :279-335)."""
        strat = self.sample_strategy
        step = max(int(round(fps / req_fps)), 1)
        n = len(feats)
        if strat in (SAMPLE_STRAT_LAST, SAMPLE_STRAT_RAND):
            keep = list(range(n))[::-step][::-1]
            if strat == SAMPLE_STRAT_RAND:
                shift = max(int(round(fps / req_fps / 3)), 1)
                # same (seed, epoch, row)-seeded scheme as the window draw
                # above: the reference uses the global RNG here, which
                # under loader threads is schedule-dependent (two runs
                # with one seed would produce different offsets)
                g = np.random.default_rng(
                    (self.random_seed, self._epoch, int(idx), 0x0FF5))
                offset = int(round(float(g.random()) * shift))
                keep = [i - offset if i - offset > 0 else i for i in keep]
        else:
            keep = list(range(n))[::step]
        feats = feats[keep]
        frame_sec = frame_sec[keep]

        fpc = self.frames_per_clip
        t = len(feats)
        if t < fpc:
            npad = fpc - t
            if strat in (SAMPLE_STRAT_LAST, SAMPLE_STRAT_RAND):
                feats = np.concatenate([np.repeat(feats[:1], npad, 0), feats])
                frame_sec = np.concatenate(
                    [np.repeat(frame_sec[:1], npad), frame_sec])
            else:
                feats = np.concatenate([feats, np.repeat(feats[-1:], npad, 0)])
                frame_sec = np.concatenate(
                    [frame_sec, np.repeat(frame_sec[-1:], npad)])
        if strat in (SAMPLE_STRAT_LAST, SAMPLE_STRAT_RAND):
            return feats[-fpc:], frame_sec[-fpc:]
        return feats[:fpc], frame_sec[:fpc]

    def _sample_mod(self, mod: str, row, idx: int = 0) \
            -> Dict[str, np.ndarray]:
        reader = self.reader_fn[mod]
        fps = reader.get_frame_rate(row["video_path"])
        new_start, new_end, req_fps = self._clip_window(
            row["start"], row["end"], fps, idx=idx)
        feats = reader.read_window(row["video_path"], new_start, new_end, fps)
        t = len(feats)
        if new_start >= new_end:
            frame_sec = np.full((t,), new_start, np.float32)
        else:
            frame_sec = np.linspace(new_start, new_end, t, dtype=np.float32)
        feats, frame_sec = self._subsample_and_pad(feats, frame_sec, fps,
                                                   req_fps, idx=idx)
        tfm = self.transforms.get(mod)
        if tfm is not None:
            if feats.dtype not in (np.float32, np.float64):
                feats = feats.astype(np.float32)  # see load_batch
            feats = tfm(feats)
        # keep reduced-precision stores (bf16 packed) as-is: transfer bytes
        # are the serving bottleneck; fp64 intermediates drop to fp32
        if feats.dtype == np.float64:
            feats = feats.astype(np.float32)
        return {"feats": feats, "frame_sec": frame_sec}

    def _get_labels(self, row) -> OrderedDict:
        labels = OrderedDict()
        for tname in self.label_type:
            col = tname + "_class"
            labels[tname] = int(row[col]) if col in row else self.dummy_label
        return labels

    @staticmethod
    def _subclip_index(total: int, num_frames: int, stride: int):
        """Window start indices of reference _get_subclips
        (base_video_dataset.py:401-415): sampled from the back so the last
        window ends exactly at the clip end."""
        starts = list(range(total - num_frames, -num_frames, -stride))[::-1]
        if not starts or starts[0] < 0:
            # the reference generates these negative window starts too, then
            # crashes in torch.stack on the ragged slices they produce;
            # surface it as a config error instead
            raise ValueError(
                f"subclip options num_frames={num_frames} stride={stride} "
                f"produce a negative window start on {total} frames "
                f"(starts {starts}); the reference _get_subclips errors on "
                f"such configs as well")
        return np.asarray(starts, np.int64)

    def _apply_subclips(self, item: Dict) -> Dict:
        """General subclips: features (T, F) -> (S*num_frames, F) — the
        windows stack that reference base_model.py:44-45 flattens into the
        temporal axis — and video_frame_sec (T,) -> (S', num_frames')."""
        f_nf = self.frame_subclips_options["num_frames"]
        f_st = self.frame_subclips_options["stride"]
        s_nf = self.sec_subclips_options["num_frames"]
        s_st = self.sec_subclips_options["stride"]
        for mod, feats in item["data_dict"].items():
            starts = self._subclip_index(len(feats), f_nf, f_st)
            gather = (starts[:, None] + np.arange(f_nf)[None]).reshape(-1)
            item["data_dict"][mod] = feats[gather]
        vfs = item["video_frame_sec"]
        starts = self._subclip_index(len(vfs), s_nf, s_st)
        item["video_frame_sec"] = vfs[starts[:, None]
                                      + np.arange(s_nf)[None]]  # (S', nf')
        return item

    def set_epoch(self, epoch: int):
        """Fold the epoch into the random_clip window draw (the reference
        draws per access, so every epoch sees fresh windows); deterministic
        strategies are unaffected."""
        self._epoch = int(epoch)

    def get_item(self, idx: int) -> Dict:
        if self._plan is not None:
            return self._get_item_fast(idx)
        row = self.df.loc[idx, :]
        data, frame_sec = {}, None
        for mod in self.reader_fn:
            s = self._sample_mod(mod, row, idx=idx)
            data[mod] = s["feats"]
            frame_sec = s["frame_sec"]
        item = {
            "data_dict": data,
            "target": self._get_labels(row),
            "uid": row.uid,
            "idx": idx,
            "video_frame_sec": frame_sec,
            "start": row["start"],
            "end": row["end"],
        }
        if not self._default_subclips:
            item = self._apply_subclips(item)
        if self.load_seg_labels:
            vfs = np.asarray(item["video_frame_sec"], np.float64)
            labels = self._label_index.labels_at(
                row["video_path"], vfs.reshape(-1), self.label_type)
            # default {1,1}: (T, 1) column vector; general: label per element
            # of the (S', nf') second-window matrix (reference
            # _get_vidseg_labels shapes labels like video_frame_sec)
            item["target_subclips"] = {
                t: v.reshape(vfs.shape if not self._default_subclips
                             else (-1, 1))
                for t, v in labels.items()}
        return item

    def __getitem__(self, idx):
        return self.get_item(idx), {}


class ConcatClipDataset:
    """Concatenation of multiple clip datasets (multi-dataset training,
    reference train.py:113-116). Class vocabularies come from the first
    dataset; all parts must share them."""

    def __init__(self, datasets: List[FeatureClipDataset]):
        assert datasets, "need at least one dataset"
        self.datasets = datasets
        self._cum = np.cumsum([len(d) for d in datasets])

    def __len__(self):
        return int(self._cum[-1])

    def set_epoch(self, epoch: int):
        for d in self.datasets:
            if hasattr(d, "set_epoch"):
                d.set_epoch(epoch)

    def get_item(self, idx: int):
        ds_i = int(np.searchsorted(self._cum, idx, side="right"))
        local = idx - (0 if ds_i == 0 else int(self._cum[ds_i - 1]))
        item = self.datasets[ds_i].get_item(local)
        # consumers treat item['idx'] as a GLOBAL row id (h5 export order
        # restore, shard merge dedup); the sub-dataset returns its local
        # one, which collides across parts
        item = dict(item)
        item["idx"] = idx
        return item

    def __getitem__(self, idx):
        return self.get_item(idx), {}

    @property
    def classes(self):
        return self.datasets[0].classes

    @property
    def classes_manyshot(self):
        return self.datasets[0].classes_manyshot

    @property
    def class_mappings(self):
        return self.datasets[0].class_mappings
