"""Pack RULSTM LMDB feature dirs into the port's packed stores.

The port's counterpart of tools/pack_features.py, with the same command
line and byte-identical output. The reference reads features through
per-frame LMDB random reads (reference datasets/reader_fns.py:65-107); this
offline tool converts each modality's LMDB environment into the packed
memmap format (``data.readers.PackedFeatureStore``): one contiguous matrix
in float32, bfloat16 or int8 (symmetric per-frame scales) plus sorted
per-video frame-id tables, so the loader gathers rows instead.

The LMDB is read through the port's native reader
(``data.lmdb_native``, its own copy of the C++ source, built with g++ at
first use); the ``lmdb`` package is not needed.

Usage: python -m afft_tpu_torch.tools.pack_features SRC_LMDB_DIR DST_DIR
           [--dtype float32|bfloat16|int8]
       python -m afft_tpu_torch.tools.pack_features --root FEATURES_ROOT \\
           OUT_ROOT  # every subdir
"""

from __future__ import annotations

import argparse
import re
from pathlib import Path

import numpy as np

from ..data.lmdb_native import NativeLmdb
from ..data.readers import PackedFeatureStore

KEY_RE = re.compile(rb"^(.*)_frame_(\d+)\.jpg$")


def iter_lmdb(src):
    """(key, value) in cursor (key) order."""
    env = NativeLmdb(str(src))
    try:
        yield from env.items()
    finally:
        env.close()


def pack_one(src, dst, dtype="float32"):
    """Pack one LMDB environment into a store at ``dst``."""
    def rows():
        n = 0
        for key, val in iter_lmdb(src):
            m = KEY_RE.match(key)
            if not m:
                continue
            yield m.group(1).decode(), int(m.group(2)), \
                np.frombuffer(val, np.float32)
            n += 1
            if n % 500000 == 0:
                print(f"  {n} rows...", flush=True)

    store = PackedFeatureStore.write_stream(dst, rows(), dtype=dtype)
    print(f"packed {src} -> {dst}: {len(store.frame_ids)} rows, "
          f"F={store.feature_dim}, {len(store.videos)} videos")
    return store


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--root", action="store_true",
                    help="treat SRC as a root of modality subdirs")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16", "int8"],
                    help="storage dtype; bfloat16 halves store size and "
                         "host->device transfer bytes; int8 (symmetric "
                         "per-frame quantization) quarters them")
    args = ap.parse_args(argv)
    if args.root:
        for sub in sorted(Path(args.src).iterdir()):
            if sub.is_dir():
                pack_one(sub, Path(args.dst) / sub.name, args.dtype)
    else:
        pack_one(args.src, args.dst, args.dtype)


if __name__ == "__main__":
    main()
