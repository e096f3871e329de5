#!/usr/bin/env python3
"""Time one served path's forward on one NVIDIA GPU, two trees of the
PyTorch/CUDA port in turns, for a comparison on one card.

    python3 tools/torch_serve_turns.py PARENT_DIR CHANGE_DIR \\
        [--expt 01_SA-Fuser_ek100_val_Swin.txt] \\
        [--override model.common.fp_output_len=4] [--order pccppc]

Each directory holds a tree's ``afft_tpu_torch`` and ``expts/`` (each
builds its kernels into its own ``build/``). Each turn of ``--order`` (p:
the first tree, c: the second) is a fresh process that builds the Server
(batch 256, bf16, seeded weights), warms up, then times ``--blocks`` blocks
of ``--iters`` forwards on device-resident features with CUDA events.
Prints one line a turn: the tree, each block's ms a forward and their
median. Imports torch and the trees' afft_tpu_torch only.
"""

import argparse
import os
import statistics
import subprocess
import sys


def one(tree, expt, overrides, blocks, iters):
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from afft_tpu_torch import serve
    cfg = serve.load_config(os.path.join(tree, "expts", expt), overrides)
    dims = {m: int(d) for m, d in cfg.model.modal_dims.to_container().items()}
    server = serve.Server(cfg, {"action": 3806}, "bfloat16", "cuda")
    requests = serve.random_requests(dims, int(cfg.data_eval.num_frames),
                                     256, 4)
    feats = server.to_device(
        {m: torch.cat([r[m] for r in requests]) for m in requests[0]})
    out = []
    with torch.no_grad():
        for _ in range(3):
            server.model(feats)
        for _ in range(blocks):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                server.model(feats)
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / iters)
    print(f"{tree} {expt} {overrides} forward ms "
          f"{[round(x, 3) for x in out]} median {statistics.median(out):.3f}",
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--expt", default="01_SA-Fuser_ek100_val_Swin.txt")
    ap.add_argument("--override", action="append", default=[])
    ap.add_argument("--order", default="pccppc")
    ap.add_argument("--blocks", type=int, default=6)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        return one(args.one, args.expt, args.override, args.blocks,
                   args.iters)
    if len(args.trees) != 2:
        ap.error("give two tree directories")
    rc = 0
    for turn in args.order:
        tree = args.trees[0 if turn == "p" else 1]
        cmd = [sys.executable, os.path.abspath(__file__), "--one", tree,
               "--expt", args.expt, "--blocks", str(args.blocks), "--iters",
               str(args.iters)]
        for o in args.override:
            cmd += ["--override", o]
        rc |= subprocess.run(cmd).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
