"""Learnable flagship-scale synthetic dataset for the full-chain
acceptance run: the port's copy of tools/make_accept_dataset.py, writing
the same files byte for byte through the port's own PackedFeatureStore
(no ``afft_tpu``, no ``ml_dtypes``).

EK100-shaped: 4 modalities at real dims (rgb 1024 / objects 352 /
audio 1024 / flow 1024), tau_a=1 / tau_o=16, T=16 @ 1 fps effective,
full 3806-action head. Labels are drawn from 64 "active" classes and the
observed window before each clip carries a class-prototype component, so
a few epochs of the REAL train entry point lift val MT5R far above
chance while the task stays non-trivial (overlapping windows, feature
noise, every-2nd-frame ids exercising the backward search).

Sizing: 32 train videos (~8.2k clips). At 8 videos the 388M flagship
memorized the 87%-overlapping train windows before the last-frame class
signal generalized (train MT5R 80, val at the 64-class chance floor).

Writes .accept_data/: annotations (EGTEA-style csvs; the csv parsing
path of EPICKitchens), bf16 packed feature stores.

Usage: python -m afft_tpu_torch.tools.make_accept_dataset [root]
    [--train-videos 32] [--val-videos 2] [--clips-per-video 256]
Fewer videos or clips cut the set's size and keep every width.
"""

from __future__ import annotations

import argparse
import zlib
from pathlib import Path

import numpy as np

from ..data.readers import PackedFeatureStore


def _stable_seed(*parts) -> int:
    """Cross-process-stable seed (python hash() is randomized)."""
    return zlib.crc32("|".join(str(p) for p in parts).encode())

MODAL_DIMS = {"rgb": 1024, "objects": 352, "audio": 1024, "flow": 1024}
N_VERBS, N_NOUNS = 97, 300
N_CLASSES = 3806
N_ACTIVE = 64
FPS = 30.0
CLIP_SPACING = 60          # frames between consecutive clip starts (2 s)
CLIPS_PER_VIDEO = 256
ID_STRIDE = 2              # features exist on every 2nd frame
WINDOW = (510, 30)         # class signal in [start-17 s, start-1 s]


def make_accept_dataset(root, n_train_videos=32, n_val_videos=2, seed=0,
                        clips_per_video=None):
    root = Path(root)
    if (root / "annotations" / "done").exists():
        return root
    videos = write_annotations(root, n_train_videos, n_val_videos, seed,
                               clips_per_video)
    write_features(root, videos)
    (root / "annotations" / "done").write_text("ok")
    n_clips = sum(len(v[1]) for v in videos.values())
    print(f"accept dataset: {n_clips} clips, {len(videos)} videos, "
          f"{N_ACTIVE} active classes -> {root}")
    return root


def write_annotations(root, n_train_videos=32, n_val_videos=2, seed=0,
                      clips_per_video=None):
    """The set's annotation csvs under ``root/annotations`` (all that the
    challenge tool reads); returns {video: (length, clip starts, labels)}
    for ``write_features``."""
    clips_per_video = clips_per_video or CLIPS_PER_VIDEO
    annot_dir = Path(root) / "annotations"
    annot_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)

    with open(annot_dir / "actions.csv", "w") as f:
        for a in range(N_CLASSES):
            v, n = a % N_VERBS, a % N_NOUNS
            f.write(f"{a}, {v}_{n}, Verb{v}_Noun{n}\n")

    active = np.sort(rng.choice(N_CLASSES, N_ACTIVE, replace=False))

    videos = {}
    rows = {"training1.csv": [], "validation1.csv": []}
    uid = 0
    n_videos = n_train_videos + n_val_videos
    for i in range(n_videos):
        # 3-char suffix => EK100 50 fps audio remap rules apply
        vid = f"A{i:02d}_{i + 100:03d}"
        length = clips_per_video * CLIP_SPACING + 1200
        split = "training1.csv" if i < n_train_videos else "validation1.csv"
        starts = 600 + CLIP_SPACING * np.arange(clips_per_video)
        # two early-start clips per video: dropped by the anticipation
        # conversion, exercising the discarded-segment path end to end
        starts = np.concatenate([[5, 20], starts])
        labels = rng.choice(active, len(starts))
        videos[vid] = (length, starts, labels)
        for s, a in zip(starts, labels):
            v, n = int(a) % N_VERBS, int(a) % N_NOUNS
            rows[split].append((uid, vid, int(s), int(s) + 90, v, n, int(a)))
            uid += 1

    for name, chunk in rows.items():
        with open(annot_dir / name, "w") as f:
            for r in chunk:
                f.write(",".join(str(x) for x in r) + "\n")
    return videos


def write_features(root, videos):
    """The bf16 packed feature stores under ``root/features_packed``."""
    root = Path(root)
    # class prototypes per modality; frames inside a clip's observed window
    # carry the prototype of the NEAREST upcoming clip start
    for mod, dim in MODAL_DIMS.items():
        proto = np.random.default_rng(_stable_seed("proto", mod)) \
            .standard_normal((N_CLASSES, dim)).astype(np.float32)

        def blocks(mod=mod, dim=dim, proto=proto):
            for vid, (length, starts, labels) in videos.items():
                max_id = int(length * 50 / 30) + 2 if mod == "audio" \
                    else length
                ids = np.arange(1, max_id + 1, ID_STRIDE)
                g = np.random.default_rng(_stable_seed(mod, vid))
                feats = g.standard_normal((len(ids), dim),
                                          dtype=np.float32)
                # map each id to its frame position (audio ids are in the
                # native-fps space; the signal window is in video frames)
                frame_pos = ids * 30.0 / 50.0 if mod == "audio" \
                    else ids.astype(np.float64)
                nxt = np.searchsorted(starts, frame_pos, side="left")
                nxt = np.clip(nxt, 0, len(starts) - 1)
                dist = starts[nxt] - frame_pos
                in_window = (dist >= WINDOW[1]) & (dist <= WINDOW[0])
                sel = np.where(in_window)[0]
                feats[sel] += 0.8 * proto[labels[nxt[sel]]]
                yield vid, ids, feats

        PackedFeatureStore.write_blocks(root / "features_packed" / mod,
                                        blocks(), dtype="bfloat16")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root", nargs="?", default=".accept_data")
    ap.add_argument("--train-videos", type=int, default=32)
    ap.add_argument("--val-videos", type=int, default=2)
    ap.add_argument("--clips-per-video", type=int, default=CLIPS_PER_VIDEO)
    args = ap.parse_args(argv)
    make_accept_dataset(args.root, args.train_videos, args.val_videos,
                        clips_per_video=args.clips_per_video)


if __name__ == "__main__":
    main()
