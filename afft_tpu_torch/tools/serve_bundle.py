"""Load and run a serving bundle written by ``tools.export_serving``.

The port's counterpart of tools/serve_bundle.py. ``load_bundle_buckets``
rebuilds the model from the bundle's expt lines and weights and returns a
bucket server over its serving function: on the card a ``GraphServer``,
which captures one CUDA graph per bucket here (a graph cannot be
serialized), on the CPU an ``EagerBucketServer``. Either refuses a batch
that does not fit one of its buckets exactly (``ValueError``), as the JAX
bundle's fixed-shape graphs do. The cold start is logged: load, build,
capture per bucket.

Usage:
  python -m afft_tpu_torch.tools.serve_bundle --bundle DIR \\
      [--input batch.npz] [--device cuda|cpu]
  python -m afft_tpu_torch.tools.serve_bundle --bundle DIR --iters 50

``--input`` is an .npz of per-modality (B, T, F) arrays with B one of the
bundle's buckets (a native-dtype bundle; int8 transport is driven by
``tools.serve_concurrent``); without it a seeded random batch of the
largest bucket is served. ``--iters N`` times N back-to-back runs of that
bucket and prints clips/s.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .. import resolve_device, serve
from ..config import CONF_DIR, compose
from ..data.readers import PackedFeatureStore
from ..serving.graphs import EagerBucketServer, GraphServer
from .export_serving import BUNDLE_META, BUNDLE_WEIGHTS


def read_meta(bundle_dir):
    with open(os.path.join(bundle_dir, BUNDLE_META)) as f:
        return json.load(f)


def _server(bundle_dir, meta, device):
    cfg = compose(CONF_DIR, meta["expt_lines"])
    weights = torch.load(os.path.join(bundle_dir, BUNDLE_WEIGHTS),
                         map_location="cpu")
    return serve.Server(cfg, meta["num_classes"], meta["feat_dtype"], device,
                        weights)


def load_bundle_buckets(bundle_dir, device="cuda", log=print):
    """(bucket server, meta): a ``GraphServer`` with one CUDA graph per
    bucket of the bundle on the card, an ``EagerBucketServer`` on the CPU.
    Logs the cold start."""
    t0 = time.perf_counter()
    meta = read_meta(bundle_dir)
    buckets = meta.get("batch_buckets") or [meta["batch"]]
    device = resolve_device(device)
    server = _server(bundle_dir, meta, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_load = time.perf_counter() - t0
    kw = dict(input_dtype=meta["input_dtype"], topk=meta["topk"])
    t0 = time.perf_counter()
    if device.type == "cuda":
        runner = GraphServer(server, buckets, log=log, **kw)
        capture = runner.capture_s
    else:
        runner = EagerBucketServer(server, buckets, **kw)
        capture = {}
    log(f"bundle {bundle_dir}: cold start {t_load:.3f} s load and build, "
        f"{time.perf_counter() - t0:.3f} s warm-up and capture "
        f"(per bucket {json.dumps(capture)}) on {device}")
    return runner, meta


def random_batch(meta, bucket, seed=0):
    """Host tensors for a random batch: (feats,) or, for an int8 bundle,
    (feats, scales) quantized per frame."""
    rng = np.random.default_rng(seed)
    T = meta["num_frames"]
    feats = {m: rng.standard_normal((bucket, T, d), dtype=np.float32)
             for m, d in meta["modal_dims"].items()}
    if meta["input_dtype"] == "int8":
        pairs = {m: PackedFeatureStore._quantize_rows(
            x.reshape(-1, x.shape[-1])) for m, x in feats.items()}
        return ({m: torch.from_numpy(q.reshape(feats[m].shape))
                 for m, (q, _) in pairs.items()},
                {m: torch.from_numpy(s.reshape(bucket, T))
                 for m, (_, s) in pairs.items()})
    dt = serve.DTYPES[meta["feat_dtype"]]
    return ({m: torch.from_numpy(x).to(dt) for m, x in feats.items()},)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bundle", required=True)
    ap.add_argument("--input", default=None, help=".npz of (B, T, F) arrays")
    ap.add_argument("--iters", type=int, default=0,
                    help=">0: time this many runs of the batch")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    runner, meta = load_bundle_buckets(args.bundle, args.device)
    if args.input:
        if meta["input_dtype"] == "int8":
            raise ValueError("--input takes a native-dtype bundle (int8 "
                             "transport is driven by tools.serve_concurrent)")
        loaded = np.load(args.input)
        dt = serve.DTYPES[meta["feat_dtype"]]
        batch = ({m: torch.from_numpy(np.asarray(loaded[m], np.float32))
                  .to(dt) for m in meta["modal_dims"]},)
    else:
        batch = random_batch(meta, meta["batch"])
    bucket = len(next(iter(batch[0].values())))
    if runner.device.type == "cuda":
        batch = tuple({m: x.pin_memory() for m, x in part.items()}
                      for part in batch)

    def run():
        out = runner.run(bucket, *batch)
        return out[0] if isinstance(out, tuple) else out  # top-k: values

    with runner.stream_context():
        first = run().float().cpu()
    print(json.dumps({"bundle": args.bundle, "bucket": bucket,
                      "logits_shape": list(first.shape),
                      "logits_mean": float(first.mean())}), flush=True)
    if args.iters > 0:
        t0 = time.perf_counter()
        with runner.stream_context():
            for _ in range(args.iters):
                out = run()
            out = out.cpu()
        seconds = time.perf_counter() - t0
        print(json.dumps({"clips_per_sec": bucket * args.iters / seconds,
                          "ms_per_batch": seconds / args.iters * 1e3,
                          "device": str(runner.device)}), flush=True)


if __name__ == "__main__":
    main()
