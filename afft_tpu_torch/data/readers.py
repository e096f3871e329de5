"""Feature stores and reader functions.

Port of afft_tpu/data/readers.py (reference datasets/reader_fns.py:40-157,
EpicRULSTMFeatsReader). The reference does one LMDB ``get`` per frame with a
<=10-step *backward* search for missing frames (anticipation-safe: never
looks forward), zeros for still-missing frames.

The store interface is a *vectorized* lookup ``get_frames(video, frame_ids)
-> (len(ids), F)``, so the hot path is one gather per clip instead of a
Python loop per frame. Three backends:

- PackedFeatureStore: the serving format. One contiguous memmap per
  modality (float32, bfloat16 or int8 rows) plus per-video sorted frame-id
  tables; backward search collapses to a ``searchsorted``.
- LmdbFeatureStore: reads the original RULSTM LMDB dirs through the port's
  native reader (``lmdb_native``; the ``lmdb`` package is not used).
- DictFeatureStore: in-memory, for tests and fixtures.

bfloat16 stores are read and written as their uint16 bit patterns, with no
``ml_dtypes``: rows widen to float32 by an exact 16-bit shift (the values
the JAX reader's bf16 arrays hold), and float32 narrows to bf16 by round to
nearest even, as ``ml_dtypes`` converts, so the files are byte-identical to
the JAX package's.

``EpicRULSTMFeatsReader`` keeps the reference's reader facade (same
``_target_`` in configs, same audio/pose fps remapping, same zero-fill
semantics) on top of whichever backend the path contains.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np

SEARCH_RADIUS = 10  # backward search window, reference reader_fns.py:79


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------

class FeatureStore:
    """Vectorized frame-feature lookup for one modality."""

    feature_dim: int

    def get_frames(self, video: str, frame_ids: np.ndarray) -> np.ndarray:
        """Return (len(frame_ids), F) float32 features with the reference's
        backward search + zero-fill semantics applied (bfloat16 and int8
        stores widen exactly / dequantize to float32)."""
        raise NotImplementedError

    def available_frames(self, video: str) -> np.ndarray:
        raise NotImplementedError


def bf16_bits(x) -> np.ndarray:
    """float32 -> bfloat16 bit patterns (uint16): round to nearest even, NaN
    to a quiet NaN of its sign (the conversion of ``ml_dtypes``)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    bits = ((u + (np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))))
            >> 16).astype(np.uint16)
    nan = np.isnan(np.ascontiguousarray(x, np.float32))
    if nan.any():
        bits[nan] = np.where(u[nan] >> 31, 0xFFC0, 0x7FC0).astype(np.uint16)
    return bits


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (uint16) -> float32, exactly."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(
        np.float32)


def resolve_backward(avail: np.ndarray, frame_ids: np.ndarray):
    """Map requested frame ids onto stored ones.

    For each requested id, find the nearest stored id in
    [id - (SEARCH_RADIUS-1), id] (reference searches offsets 0..9). Returns
    (row_indices, found_mask); unfound rows must be zero-filled.
    """
    idx = np.searchsorted(avail, frame_ids, side="right") - 1
    safe = np.clip(idx, 0, None)
    found = (idx >= 0) & (frame_ids - avail[safe] <= SEARCH_RADIUS - 1)
    return safe, found


class DictFeatureStore(FeatureStore):
    """{video: {frame_id: (F,) float32}} in memory."""

    def __init__(self, table: Dict[str, Dict[int, np.ndarray]]):
        self.table = table
        self._avail = {v: np.array(sorted(d.keys()), dtype=np.int64)
                       for v, d in table.items()}
        any_feat = next(iter(next(iter(table.values())).values()))
        self.feature_dim = int(any_feat.shape[-1])

    def available_frames(self, video):
        return self._avail[video]

    def get_frames(self, video, frame_ids):
        avail = self._avail[video]
        rows, found = resolve_backward(avail, np.asarray(frame_ids))
        assert found.any(), f"No features found for {video} - {frame_ids}"
        out = np.zeros((len(frame_ids), self.feature_dim), np.float32)
        vids = self.table[video]
        for i, (r, ok) in enumerate(zip(rows, found)):
            if ok:
                out[i] = vids[int(avail[r])]
        return out


class PackedFeatureStore(FeatureStore):
    """Packed serving format: meta.json + features.bin + frame_ids.bin.

    meta.json: {"feature_dim": F, "dtype": ..., "videos": {name:
    {"row_offset": int, "num_rows": int}}}. features.bin is (total_rows, F)
    float32, or bfloat16 (kept as uint16 bit patterns); frame_ids.bin is
    int64 (total_rows,) ascending per video.

    ``dtype='int8'`` stores symmetric per-frame quantization (q = round(x *
    127 / max|row|), scales.bin fp32 (total_rows,)): 4x smaller than fp32,
    2x smaller than bf16; gathers dequantize to fp32 (worst-case error
    max|row|/254 per element).
    """

    MAGIC = "afft-fdb-v1"

    @staticmethod
    def _dtype(name: str):
        """numpy storage dtype of a store dtype name."""
        return np.dtype(np.uint16 if name == "bfloat16" else name)

    @staticmethod
    def _encode(feats, dtype: str) -> np.ndarray:
        """float32 rows -> the stored representation of a float dtype."""
        if dtype == "bfloat16":
            return bf16_bits(feats)
        return np.ascontiguousarray(feats).astype(np.dtype(dtype))

    @staticmethod
    def _quantize_rows(feats: np.ndarray):
        """fp32 (n, F) -> (int8 (n, F), fp32 scales (n,)), symmetric."""
        feats = np.asarray(feats, np.float32)
        absmax = np.abs(feats).max(axis=-1)
        scales = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
        q = np.clip(np.rint(feats / scales[:, None]), -127, 127)
        return q.astype(np.int8), scales

    def __init__(self, path: Union[str, Path]):
        path = Path(path)
        meta = json.loads((path / "meta.json").read_text())
        assert meta.get("format") == self.MAGIC, f"not a packed store: {path}"
        self.feature_dim = meta["feature_dim"]
        self.videos = meta["videos"]
        self.dtype_name = meta.get("dtype", "float32")
        self.dtype = self._dtype(self.dtype_name)
        total = sum(v["num_rows"] for v in self.videos.values())
        self.features = np.memmap(path / "features.bin", dtype=self.dtype,
                                  mode="r", shape=(total, self.feature_dim))
        self.frame_ids = np.memmap(path / "frame_ids.bin", dtype=np.int64,
                                   mode="r", shape=(total,))
        self.scales = None
        if self.dtype == np.int8:
            self.scales = np.memmap(path / "scales.bin", dtype=np.float32,
                                    mode="r", shape=(total,))

    def _decode(self, rows_feats: np.ndarray, rows: np.ndarray):
        """Stored rows -> float32: bf16 widened, int8 dequantized."""
        if self.dtype_name == "bfloat16":
            return bf16_to_f32(rows_feats)
        if self.scales is None:
            return rows_feats
        return rows_feats.astype(np.float32) * \
            np.asarray(self.scales[rows], np.float32)[..., None]

    @classmethod
    def _write_meta(cls, path, feature_dim, dtype, meta_videos):
        (path / "meta.json").write_text(json.dumps({
            "format": cls.MAGIC, "feature_dim": feature_dim,
            "dtype": dtype, "videos": meta_videos}))

    @classmethod
    def write(cls, path: Union[str, Path],
              videos: Dict[str, Dict[int, np.ndarray]],
              dtype: str = "float32"):
        """Build a packed store from {video: {frame_id: (F,) feature}}.

        ``dtype='bfloat16'`` halves the store (features originate as fp32;
        bf16 keeps 8 mantissa bits, well inside model tolerance).
        """
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        names = sorted(videos)
        feature_dim = None
        meta_videos, feats, ids = {}, [], []
        offset = 0
        for name in names:
            frames = sorted(videos[name])
            for fid in frames:
                feat = np.asarray(videos[name][fid], np.float32)
                feature_dim = feature_dim or feat.shape[-1]
                feats.append(feat)
                ids.append(fid)
            meta_videos[name] = {"row_offset": offset,
                                 "num_rows": len(frames)}
            offset += len(frames)
        all_feats = np.concatenate([f[None] for f in feats])
        if dtype == "int8":
            q, scales = cls._quantize_rows(all_feats)
            q.tofile(path / "features.bin")
            scales.tofile(path / "scales.bin")
        else:
            cls._encode(all_feats, dtype).tofile(path / "features.bin")
        np.asarray(ids, np.int64).tofile(path / "frame_ids.bin")
        cls._write_meta(path, feature_dim, dtype, meta_videos)
        return cls(path)

    @classmethod
    def write_blocks(cls, path, blocks, dtype: str = "float32"):
        """Vectorized build from (video, ids (n,), feats (n, F)) blocks,
        one per video in name order. Constant memory, no per-row Python."""
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        meta_videos = {}
        feature_dim = None
        offset = 0
        with open(path / "features.bin", "wb") as f_feat, \
                open(path / "frame_ids.bin", "wb") as f_ids, \
                open(path / "scales.bin", "wb") as f_scales:
            for video, ids, feats in blocks:
                feature_dim = feature_dim or int(np.shape(feats)[-1])
                if dtype == "int8":
                    q, scales = cls._quantize_rows(feats)
                    f_feat.write(q.tobytes())
                    f_scales.write(scales.tobytes())
                else:
                    f_feat.write(cls._encode(feats, dtype).tobytes())
                ids_arr = np.asarray(ids, np.int64)
                assert np.all(np.diff(ids_arr) > 0), \
                    f"frame ids for {video!r} must be strictly ascending: " \
                    f"resolve_backward's searchsorted would silently " \
                    f"return wrong rows on an unsorted id table"
                f_ids.write(ids_arr.tobytes())
                assert video not in meta_videos, \
                    f"duplicate video block {video!r}: blocks must be " \
                    f"grouped per video (silent offset corruption otherwise)"
                meta_videos[video] = {"row_offset": offset,
                                      "num_rows": len(ids)}
                offset += len(ids)
        if dtype != "int8":
            (path / "scales.bin").unlink()
        cls._write_meta(path, feature_dim, dtype, meta_videos)
        return cls(path)

    @classmethod
    def write_stream(cls, path, rows, dtype: str = "float32"):
        """Streaming build from an iterator of (video, frame_id, feat_bytes)
        grouped by video with ascending frame ids — the order an LMDB cursor
        yields, since keys embed zero-padded frame numbers. Constant memory.
        """
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        meta_videos = {}
        feature_dim = None
        offset = 0
        cur_video, cur_count = None, 0
        with open(path / "features.bin", "wb") as f_feat, \
                open(path / "frame_ids.bin", "wb") as f_ids, \
                open(path / "scales.bin", "wb") as f_scales:
            for video, fid, feat in rows:
                if dtype == "int8":
                    q, scale = cls._quantize_rows(
                        np.asarray(feat, np.float32)[None])
                    feat = q[0]
                    f_scales.write(scale.tobytes())
                else:
                    feat = cls._encode(np.asarray(feat, np.float32), dtype)
                if feature_dim is None:
                    feature_dim = int(feat.shape[-1])
                if video != cur_video:
                    if cur_video is not None:
                        meta_videos[cur_video] = {
                            "row_offset": offset, "num_rows": cur_count}
                        offset += cur_count
                    assert video not in meta_videos, \
                        f"rows for video {video!r} are not contiguous: " \
                        f"the stream must be grouped per video (offsets " \
                        f"would silently corrupt otherwise)"
                    cur_video, cur_count = video, 0
                    prev_fid = None
                assert prev_fid is None or fid > prev_fid, \
                    f"frame ids for {video!r} must be strictly ascending " \
                    f"({prev_fid} -> {fid}): resolve_backward's " \
                    f"searchsorted would silently return wrong rows"
                prev_fid = fid
                f_feat.write(feat.tobytes())
                f_ids.write(np.int64(fid).tobytes())
                cur_count += 1
            if cur_video is not None:
                meta_videos[cur_video] = {"row_offset": offset,
                                          "num_rows": cur_count}
        if dtype != "int8":
            (path / "scales.bin").unlink()
        cls._write_meta(path, feature_dim, dtype, meta_videos)
        return cls(path)

    def available_frames(self, video):
        v = self.videos[video]
        o, n = v["row_offset"], v["num_rows"]
        return self.frame_ids[o:o + n]

    def get_frames(self, video, frame_ids):
        v = self.videos[video]
        o, n = v["row_offset"], v["num_rows"]
        avail = self.frame_ids[o:o + n]
        rows, found = resolve_backward(avail, np.asarray(frame_ids))
        assert found.any(), f"No features found for {video} - {frame_ids}"
        out = np.asarray(self.features[o + rows])  # vectorized memmap gather
        out = self._decode(out, o + rows)
        out[~found] = 0
        return out

    def get_frames_batch(self, videos, frame_ids):
        """Batched gather: videos (B,) names, frame_ids (B, T) ->
        (B, T, F). One searchsorted + one memmap gather per unique video."""
        frame_ids = np.asarray(frame_ids)
        B, T = frame_ids.shape
        global_rows = np.zeros((B, T), np.int64)
        found_all = np.zeros((B, T), bool)
        videos = np.asarray(videos)
        for video in np.unique(videos):
            sel = videos == video
            v = self.videos[str(video)]
            o, n = v["row_offset"], v["num_rows"]
            avail = self.frame_ids[o:o + n]
            rows, found = resolve_backward(avail, frame_ids[sel].ravel())
            found = found.reshape(-1, T)
            assert found.any(axis=1).all(), \
                f"No features found for {video} (reference reader asserts " \
                f"per clip, reader_fns.py:97)"
            global_rows[sel] = (o + rows).reshape(-1, T)
            found_all[sel] = found
        out = np.asarray(self.features[global_rows.ravel()])
        out = self._decode(out, global_rows.ravel())
        out = out.reshape(B, T, self.feature_dim)
        out[~found_all] = 0
        return out


class LmdbFeatureStore(FeatureStore):
    """Original RULSTM LMDB dirs. Key format '{video}_frame_{:010d}.jpg'.
    Read through the port's native reader (``lmdb_native``)."""

    def __init__(self, path: Union[str, Path]):
        from .lmdb_native import NativeLmdb
        self.path = str(path)
        self.env = NativeLmdb(self.path)
        self.feature_dim = None  # discovered on first read

    def available_frames(self, video):
        raise NotImplementedError(
            "LMDB stores are not indexed; pack them into a PackedFeatureStore")

    def get_frames(self, video, frame_ids):
        feats = []
        with self.env.begin() as txn:
            for fid in np.asarray(frame_ids):
                dd = None
                for radius in range(SEARCH_RADIUS):
                    key = f"{video}_frame_{int(fid) - radius:010d}.jpg"
                    dd = txn.get(key.encode("utf-8"))
                    if dd is not None:
                        break
                feats.append(None if dd is None
                             else np.frombuffer(dd, "float32"))
        not_none = [f for f in feats if f is not None]
        assert not_none, f"No features found for {video} - {frame_ids}"
        self.feature_dim = not_none[0].shape[-1]
        zero = np.zeros_like(not_none[0])
        return np.stack([zero if f is None else f for f in feats]).astype(
            np.float32)


def open_store(path: Union[str, Path]) -> FeatureStore:
    path = Path(path)
    if (path / "meta.json").exists():
        return PackedFeatureStore(path)
    return LmdbFeatureStore(path)


# ---------------------------------------------------------------------------
# reference-compatible reader facades
# ---------------------------------------------------------------------------

class EpicRULSTMFeatsReader:
    """Reads per-frame RULSTM features for the observed window.

    Interface-compatible with the reference reader (same ``_target_`` string
    in configs, reference datasets/reader_fns.py:40-157): accepts one lmdb
    path or a list (features concatenated), converts audio/pose frame indices
    from RULSTM 30 fps to the native video fps, zero-fills missing frames.
    """

    def __init__(self, lmdb_path: Union[str, List[str], None] = None,
                 warn_if_using_closeby_frame: bool = True):
        if not isinstance(lmdb_path, (list, tuple)):
            lmdb_path = [lmdb_path]
        self.lmdb_path = [str(p) for p in lmdb_path]
        self.stores = [open_store(p) for p in self.lmdb_path]
        self.warn_if_using_closeby_frame = warn_if_using_closeby_frame

    @staticmethod
    def get_frame_rate(video_path) -> float:
        return 30.0  # RULSTM features are stored at 30 fps

    @staticmethod
    def _get_orig_video_fps(video_name: str) -> float:
        """EPIC audio/pose features index by native video fps
        (reference reader_fns.py:148-156)."""
        length = len(video_name.split("_")[-1])
        if length == 3:  # epic 100
            return 50.0
        if length == 2:  # epic 55
            return 59.94005994005994
        raise ValueError(f"Unknown video name format: {video_name}")

    def frame_ids_for_window(self, start_sec: float, end_sec: float,
                             fps: float) -> np.ndarray:
        """Frame ids covering (start, end]; ids below 1 are replaced by the
        smallest valid id (reference reader_fns.py:117-123)."""
        start_frame = np.floor(start_sec * fps)
        end_frame = np.floor(end_sec * fps)
        frames = np.arange(end_frame, start_frame, -1).astype(int)[::-1]
        if frames.size == 0:
            raise ValueError(
                f"window ({start_sec}, {end_sec}] covers no frame at "
                f"fps={fps} (shorter than one frame period)")
        assert frames.max() >= 1, \
            f"observed window fully before the video start: {start_sec}-{end_sec}"
        frames[frames < 1] = frames[frames >= 1].min()
        return frames

    def read_window(self, video_path, start_sec: float, end_sec: float,
                    fps: float) -> np.ndarray:
        """Features for the window, shape (T, F_total)."""
        video_name = Path(str(video_path)).stem
        frames = self.frame_ids_for_window(start_sec, end_sec, fps)
        return self.read_ids(video_name, frames, fps)

    def read_ids(self, video_name: str, frames: np.ndarray,
                 fps: float) -> np.ndarray:
        """Gather exact frame ids (precomputed-plan fast path). Per-store
        audio/pose remap is elementwise, so remapping a subsampled id list
        equals subsampling the remapped full list."""
        feats = []
        for store, path in zip(self.stores, self.lmdb_path):
            if "audio" in path or "poses" in path:
                orig_fps = self._get_orig_video_fps(video_name)
                fr = np.rint(frames / fps * orig_fps).astype(int)
            else:
                fr = frames
            feats.append(store.get_frames(video_name, fr))
        if len(feats) == 1:
            return feats[0]
        return np.concatenate(feats, axis=-1)

    def supports_batch(self) -> bool:
        return all(hasattr(s, "get_frames_batch") for s in self.stores)

    def read_ids_batch(self, video_names, frames, fps: float) -> np.ndarray:
        """Batched gather: video_names (B,), frames (B, T) -> (B, T, F)."""
        frames = np.asarray(frames)
        feats = []
        for store, path in zip(self.stores, self.lmdb_path):
            if "audio" in path or "poses" in path:
                fr = np.stack([
                    np.rint(f / fps * self._get_orig_video_fps(v)).astype(int)
                    for v, f in zip(video_names, frames)])
            else:
                fr = frames
            feats.append(store.get_frames_batch(video_names, fr))
        if len(feats) == 1:
            return feats[0]
        return np.concatenate(feats, axis=-1)

    # reference Reader protocol (used by item-level compatibility paths)
    def __call__(self, video_path, start, end, fps, df_row=None, **kwargs):
        feats = self.read_window(video_path, start, end, fps)
        return feats[:, None, None, :], {}, {}, {}


class DefaultReader:
    """Raw-video reader (reference datasets/reader_fns.py:23-37; upstream
    uses torchvision/pyav — this image decodes through OpenCV, which carries
    its own ffmpeg). Returns frames for the [start_sec, end_sec] window as
    (T, H, W, 3) RGB uint8, frame t included when start <= pts <= end like
    torchvision.io.read_video with pts_unit='sec'. Unused by every shipped
    config (all consume pre-extracted features) but a working component of
    the public surface."""

    def _read_window_fps(self, video_path, start_sec: float, end_sec: float,
                         fps: Optional[float] = None):
        """One VideoCapture open per call; returns (frames, native fps)."""
        import cv2
        cap = cv2.VideoCapture(str(video_path))
        if not cap.isOpened():
            raise FileNotFoundError(f"cannot open video {video_path}")
        vfps = cap.get(cv2.CAP_PROP_FPS) or (fps or 30.0)
        first = int(np.ceil(start_sec * vfps - 1e-6))
        cap.set(cv2.CAP_PROP_POS_FRAMES, max(first, 0))
        frames = []
        t = max(first, 0)
        while True:
            ok, frame = cap.read()
            if not ok or t / vfps > end_sec + 1e-6:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            t += 1
        cap.release()
        if not frames:
            raise ValueError(
                f"no frames in [{start_sec}, {end_sec}]s of {video_path}")
        return np.stack(frames), vfps

    def read_window(self, video_path, start_sec: float, end_sec: float,
                    fps: Optional[float] = None) -> np.ndarray:
        return self._read_window_fps(video_path, start_sec, end_sec, fps)[0]

    def __call__(self, video_path, start, end, fps=None, df_row=None,
                 **kwargs):
        video, vfps = self._read_window_fps(video_path, start, end, fps)
        # (video, audio, info, timings) like the reference's pyav tuple;
        # audio decoding is out of scope for the feature-based pipeline
        return video, np.zeros((0,), np.float32), {"video_fps": vfps}, {}

    @staticmethod
    def get_frame_rate(video_path) -> float:
        import cv2
        cap = cv2.VideoCapture(str(video_path))
        rate = cap.get(cv2.CAP_PROP_FPS)
        cap.release()
        return rate

