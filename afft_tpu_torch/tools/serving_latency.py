"""Per-batch device latency of the flagship's served forward, graph and eager.

The port's counterpart of tools/serving_latency.py. For each batch size B
the features lie on the card already; the served forward (``Server``'s
serving function: ``BaseModel``, ``head_logits``, the dense logits) runs
as B's captured CUDA graph (``serving.graphs.GraphServer``) and eagerly,
each timed with CUDA events over a window of ``--iters`` back-to-back calls
(best of three windows), so the host's launch cost shows where the eager
forward cannot hide it.

Usage:
  python -m afft_tpu_torch.tools.serving_latency [--batches 1 8 32 256] \\
      [--output-len N] [--iters 50] [-c expts/01_SA-Fuser_ek100_val_Swin.txt]
``--output-len N`` (> 1) serves the KV-cache rollout. Prints one JSON
line: {"latency_ms": {"graph": {"1": ...}, "eager": {...}}, ...}. Needs
the card; seeded weights.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from .. import resolve_device
from ..serve import Server, load_config
from ..serving.graphs import EagerBucketServer, GraphServer

FLAGSHIP = "expts/01_SA-Fuser_ek100_val_Swin.txt"
N_CLASSES = {"action": 3806}


def window_ms(fn, iters, windows=3):
    """The best window's mean ms a call over ``iters`` back-to-back calls
    (CUDA events; two warm-up calls first)."""
    for _ in range(2):
        fn()
    best = float("inf")
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def measure(server, batches, iters, log=None):
    """{"graph": {B: ms}, "eager": {B: ms}} over device-resident features,
    the two timed in turns per batch (graph, eager, eager, graph; the mean
    of each one's two turns)."""
    graphs = GraphServer(server, batches, log=log)
    eager = EagerBucketServer(server, batches)
    out = {"graph": {}, "eager": {}}
    for b in graphs.buckets:
        static = graphs.inputs[b]
        gen = torch.Generator(device=server.device)
        gen.manual_seed(b)
        for m, x in static[0].items():
            x.copy_(torch.randn(x.shape, generator=gen, device=x.device))
        fns = {"graph": lambda: graphs.replay(b),
               "eager": lambda: eager.fn(*static)}
        turns = {k: [] for k in fns}
        # both on the graph server's stream, where the events are recorded
        with graphs.stream_context():
            for k in ("graph", "eager", "eager", "graph"):
                turns[k].append(window_ms(fns[k], iters))
        for k, v in turns.items():
            out[k][str(b)] = sum(v) / len(v)
        if log is not None:
            log(f"B={b}: graph {out['graph'][str(b)]:.4f} ms, eager "
                f"{out['eager'][str(b)]:.4f} ms a batch")
    return out, graphs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-c", "--cfg", default=FLAGSHIP)
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 8, 32, 256])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--output-len", type=int, default=1)
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args(argv)

    device = resolve_device("cuda")
    cfg = load_config(args.cfg,
                      [f"model.common.fp_output_len={args.output_len}"])
    server = Server(cfg, N_CLASSES, args.dtype, device)
    latency, graphs = measure(
        server, args.batches, args.iters,
        log=lambda *a: print(*a, file=sys.stderr, flush=True))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "what": "served forward device latency, device-resident features, "
                "CUDA events over back-to-back calls",
        "expt": args.cfg, "output_len": args.output_len,
        "dtype": args.dtype, "latency_ms": latency,
        "capture_s": {str(b): s for b, s in graphs.capture_s.items()},
        "device": torch.cuda.get_device_name(device), "nvidia_smi": smi,
    }), flush=True)


if __name__ == "__main__":
    main()
