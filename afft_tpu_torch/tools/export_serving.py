"""Export a serving bundle: the weights, the expt and the serving contract.

The port's counterpart of tools/export_serving.py. A bundle directory
holds ``weights.pt`` (the served model's state dict in the reference
layout, ``torch.save``; ``weights.py`` and ``Server(weights=...)`` load
it) and ``meta.json`` with the JAX bundle's keys (``batch``, the largest
bucket; ``batch_buckets``; ``input_dtype``; ``topk``; ``output_len``;
``num_frames``; ``modal_dims``; ``feat_dtype``; ``num_classes``;
``ckpt_paths``, or the ``RANDOM-INIT`` provenance string), plus
``platforms: ["cuda"]``, ``torch_version`` and ``expt_lines``: the composed
expt lines, from which the loader rebuilds the model through the port's
own code.

A CUDA graph cannot be serialized: ``tools.serve_bundle``'s
``load_bundle_buckets`` captures one per bucket when it loads the bundle
(``serving.graphs.GraphServer``) and logs its cold start (load, build,
capture per bucket).

Usage:
  python -m afft_tpu_torch.tools.export_serving \\
      -c expts/01_SA-Fuser_ek100_val_Swin.txt --batch 8,64,256 \\
      [--ckpt MODEL/checkpoint_best ...] [--dtype bfloat16|float32] \\
      [--input-dtype native|int8] [--topk K] [--output-len N] \\
      [--num-classes action:3806] [--device cuda|cpu] [--out DIR]

Without ``--ckpt`` the bundle serves seeded random weights, and
``meta.json`` says so. The default device is the card; ``--device cpu``
draws and writes the weights on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from .. import serve
from ..config import CONF_DIR, compose, read_expt_file
from ..train.checkpoint import init_from_model

BUNDLE_WEIGHTS = "weights.pt"
BUNDLE_META = "meta.json"
DEFAULT_OUT = "serving_bundle_torch"


def export_bundle(expt_lines, out_dir, num_classes, batch, dtype="bfloat16",
                  ckpt_paths=None, log=print, input_dtype="native", topk=0,
                  device="cuda", weights=None):
    """Write a bundle of the model that ``expt_lines`` (override lines
    over ``afft_tpu_torch/conf``) compose; ``batch`` an int or a list of
    bucket sizes. The weights: ``ckpt_paths`` merged in order over the
    model (``train.checkpoint.init_from_model``), or ``weights`` (a state
    dict), or the seeded init of the config's seed. Returns ``out_dir``."""
    buckets = sorted({int(b) for b in
                      (batch if isinstance(batch, (list, tuple)) else
                       [batch])})
    if input_dtype not in serve.INPUT_DTYPES:
        raise ValueError(f"input_dtype {input_dtype!r}: one of "
                         f"{serve.INPUT_DTYPES}")
    expt_lines = list(expt_lines)
    cfg = compose(CONF_DIR, expt_lines)
    if weights is not None:
        provenance = "state dict given to export_bundle"
    elif ckpt_paths:
        provenance = [str(p) for p in ckpt_paths]
    else:
        provenance = serve.RANDOM_INIT
    if ckpt_paths and weights is None:
        server = serve.Server(cfg, num_classes, "float32", "cpu")
        weights, _ = init_from_model(server.model.state_dict(), ckpt_paths)
    server = serve.Server(cfg, num_classes, dtype, device, weights,
                          topk=topk)
    os.makedirs(out_dir, exist_ok=True)
    torch.save({k: v.cpu() for k, v in server.model.state_dict().items()},
               os.path.join(out_dir, BUNDLE_WEIGHTS))
    meta = {
        "batch": buckets[-1],
        "batch_buckets": buckets,
        "input_dtype": input_dtype,
        "topk": int(topk),
        "output_len": server.output_len,
        "num_frames": server.n_frames,
        "modal_dims": server.modal_dims,
        "feat_dtype": dtype,
        "num_classes": {k: int(v) for k, v in num_classes.items()},
        "platforms": ["cuda"],
        "torch_version": torch.__version__,
        "ckpt_paths": provenance,
        "expt_lines": expt_lines,
    }
    with open(os.path.join(out_dir, BUNDLE_META), "w") as f:
        json.dump(meta, f, indent=1)
    if provenance == serve.RANDOM_INIT:
        log("WARNING: exported WITHOUT a checkpoint: the bundle serves "
            "seeded random weights (meta.json marks it RANDOM-INIT)")
    log(f"serving bundle -> {out_dir} (buckets {buckets}, T "
        f"{server.n_frames}, dims {server.modal_dims}, {dtype}, input "
        f"{input_dtype}, topk {topk})")
    return out_dir


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-c", "--cfg", required=True,
                    help="expt override file (run.py format)")
    ap.add_argument("--ckpt", nargs="*", default=None,
                    help="checkpoint(s) under checkpoints/ to load")
    ap.add_argument("--batch", default="256",
                    help="batch size, or comma list of bucket sizes")
    ap.add_argument("--num-classes", default="action:3806",
                    help="comma list target:count")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=sorted(serve.DTYPES))
    ap.add_argument("--input-dtype", default="native",
                    choices=serve.INPUT_DTYPES,
                    help="int8: per-frame-quantized features + fp32 scales, "
                         "dequantized on the device")
    ap.add_argument("--topk", type=int, default=0,
                    help=">0: (values, indices) of the top-k classes "
                         "instead of dense logits")
    ap.add_argument("--output-len", type=int, default=None,
                    help="override model.common.fp_output_len (>1: the "
                         "KV-cache rollout)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    lines = read_expt_file(args.cfg)
    if args.output_len:
        lines.append(f"model.common.fp_output_len={args.output_len}")
    num_classes = {k: int(v) for k, v in
                   (kv.split(":") for kv in args.num_classes.split(","))}
    ckpts = [os.path.join("checkpoints", p) for p in args.ckpt] \
        if args.ckpt else None
    export_bundle(lines, args.out, num_classes,
                  [int(b) for b in args.batch.split(",")], args.dtype, ckpts,
                  input_dtype=args.input_dtype, topk=args.topk,
                  device=args.device)


if __name__ == "__main__":
    main()
