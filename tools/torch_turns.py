#!/usr/bin/env python3
"""Two trees of the PyTorch/CUDA port in turns on one NVIDIA GPU: one
workload's numbers for the parent and a change, measured in one call.

    python3 tools/torch_turns.py startup PARENT_DIR CHANGE_DIR \\
        [--order pccppccp]
    python3 tools/torch_turns.py serve PARENT_DIR CHANGE_DIR \\
        [--expt 01_SA-Fuser_ek100_val_Swin.txt] \\
        [--override model.common.fp_output_len=4] [--order pccppc]
    python3 tools/torch_turns.py long PARENT_DIR CHANGE_DIR [--order pccp]

Each directory holds a tree's ``afft_tpu_torch`` and ``expts/`` (and, for
``long``, its ``chip_smoke.py``); each builds its kernels into its own
``build/``, the two builds side by side first, untimed. Each turn of
``--order`` (p: the first tree, c: the second) is a fresh process in its
tree that runs the workload and prints one JSON line, printed here with the
turn, the tree and the process's wall seconds:

* ``startup``: what a fresh process pays before its work (every
  subprocess of ``chip_smoke.py``): the seconds to import torch and the
  package, load the kernel library, build the flagship's Server (bf16,
  seeded weights) and run one forward at batch 8.
* ``serve``: one served path's forward: the Server of ``--expt`` (batch
  256, bf16, seeded weights), warmed up, then ``--blocks`` blocks of
  ``--iters`` forwards on device-resident features timed with CUDA
  events; each block's ms a forward and their median.
* ``long``: phase 16 of ``chip_smoke.py`` (long contexts on the long
  attention route): the served T-64 forward, the T-48 and 35-token rollout
  training steps, the phase's seconds and each row's long-route numbers. A
  failing check fails the turn.

Imports torch and the trees' own code only.
"""

import argparse
import json
import os
import subprocess
import sys
import time

STARTUP = r'''
import json, os, sys, time
t0 = time.perf_counter()
sys.path.insert(0, os.getcwd())
import torch
from afft_tpu_torch import serve
from afft_tpu_torch.ops import _build
t1 = time.perf_counter()
_build.library()
torch.cuda.synchronize()
t2 = time.perf_counter()
cfg = serve.load_config("expts/01_SA-Fuser_ek100_val_Swin.txt")
server = serve.Server(cfg, {"action": 3806}, "bfloat16", "cuda")
torch.cuda.synchronize()
t3 = time.perf_counter()
feats = {m: torch.zeros(8, 16, int(d), device="cuda", dtype=torch.bfloat16)
         for m, d in cfg.model.modal_dims.to_container().items()}
with torch.no_grad():
    server.serving_fn("native", 0)(feats)
torch.cuda.synchronize()
t4 = time.perf_counter()
print(json.dumps({"import": t1 - t0, "library": t2 - t1, "server": t3 - t2,
                  "forward": t4 - t3}))
'''

SERVE = r'''
import json, os, statistics, sys
sys.path.insert(0, os.getcwd())
import torch
from afft_tpu_torch import serve
args = json.loads(sys.argv[1])
cfg = serve.load_config(os.path.join("expts", args["expt"]),
                        args["override"])
dims = {m: int(d) for m, d in cfg.model.modal_dims.to_container().items()}
server = serve.Server(cfg, {"action": 3806}, "bfloat16", "cuda")
requests = serve.random_requests(dims, int(cfg.data_eval.num_frames), 256, 4)
feats = server.to_device(
    {m: torch.cat([r[m] for r in requests]) for m in requests[0]})
out = []
with torch.no_grad():
    for _ in range(3):
        server.model(feats)
    for _ in range(args["blocks"]):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args["iters"]):
            server.model(feats)
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / args["iters"])
print(json.dumps({"expt": args["expt"], "override": args["override"],
                  "forward_ms": out, "median_ms": statistics.median(out)}))
'''

LONG = r'''
import json, os, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as S
peaks = S.peaks_for(torch.cuda.get_device_name(0))
kernels = {name: {"name": name} for name in S.LONG_ROWS}
out = S.phase_long(peaks, kernels)
keys = ("ms", "plain_ms", "library_ms", "bound_ms")
print(json.dumps({
    "serve_forward_ms": out["serve"]["forward_ms"],
    "t48_ms_per_step": out["train"]["t48"]["ms_per_step"],
    "rollout35_ms_per_step": out["train"]["rollout35"]["ms_per_step"],
    "seconds": out["seconds"], "floors": out.get("floors"),
    "rows": {name: {label: {k: sub.get(k) for k in keys}
                    for label, sub in e.items() if isinstance(sub, dict)}
             for name, e in kernels.items()}}))
'''

WORKLOADS = {"startup": (STARTUP, "pccppccp"), "serve": (SERVE, "pccppc"),
             "long": (LONG, "pccp")}
BUILD = ("import sys, os; sys.path.insert(0, os.getcwd()); "
         "from afft_tpu_torch.ops import _build; _build.library()")


def turn(tree, child, args):
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", child, json.dumps(args)],
                         cwd=tree, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    if out.returncode or not lines:
        raise RuntimeError(f"{tree}: rc {out.returncode}\n"
                           f"{out.stdout[-6000:]}\n{out.stderr[-6000:]}")
    return {**json.loads(lines[-1]), "wall": wall}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("workload", choices=sorted(WORKLOADS))
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--order", help="p / c a turn (default: the workload's)")
    ap.add_argument("--expt", default="01_SA-Fuser_ek100_val_Swin.txt",
                    help="serve: the expt file under expts/")
    ap.add_argument("--override", action="append", default=[],
                    help="serve: a config override (repeatable)")
    ap.add_argument("--blocks", type=int, default=6, help="serve")
    ap.add_argument("--iters", type=int, default=10, help="serve")
    args = ap.parse_args(argv)
    child, order = WORKLOADS[args.workload]
    trees = {"p": os.path.abspath(args.parent),
             "c": os.path.abspath(args.change)}
    procs = [(t, subprocess.Popen([sys.executable, "-c", BUILD], cwd=t,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
             for t in trees.values()]
    for tree, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{tree}: the kernels did not build\n{log}")
    child_args = {"expt": args.expt, "override": args.override,
                  "blocks": args.blocks, "iters": args.iters}
    for i, key in enumerate(args.order or order):
        record = turn(trees[key], child, child_args)
        print(json.dumps({"turn": i, "tree": key, **record}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
