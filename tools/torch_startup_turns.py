#!/usr/bin/env python3
"""Time a fresh process's start-up on one NVIDIA GPU, two trees of the
PyTorch/CUDA port in turns: what every subprocess of ``chip_smoke.py``
(the launcher, eval and torchrun phases) pays before its work.

    python3 tools/torch_startup_turns.py PARENT_DIR CHANGE_DIR \\
        [--order pccppccp]

Each directory holds a tree's ``afft_tpu_torch`` and ``expts/`` (each
builds its kernels into its own ``build/``; the two builds run side by
side first, untimed). Each turn of ``--order`` (p: the first tree, c: the
second) is a fresh process that imports torch and the tree's package,
loads the kernel library, builds the flagship's Server (bf16, seeded
weights) and runs one forward at batch 8. Prints one JSON line a turn:
the seconds of each stage and the process's wall. Imports torch and the
trees' afft_tpu_torch only.
"""

import argparse
import json
import os
import subprocess
import sys
import time

CHILD = r'''
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


def turn(tree):
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=tree,
                         capture_output=True, text=True)
    wall = time.perf_counter() - t0
    if out.returncode:
        raise RuntimeError(f"{tree}: {out.stdout}\n{out.stderr}")
    return {**json.loads(out.stdout.strip().splitlines()[-1]), "wall": wall}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--order", default="pccppccp")
    args = ap.parse_args(argv)
    trees = {"p": args.parent, "c": args.change}
    build = ("import sys, os; sys.path.insert(0, os.getcwd()); "
             "from afft_tpu_torch.ops import _build; _build.library()")
    procs = [subprocess.Popen([sys.executable, "-c", build], cwd=t)
             for t in trees.values()]
    if any(p.wait() for p in procs):
        raise RuntimeError("a tree's kernels did not build")
    for key in args.order:
        name = "parent" if key == "p" else "change"
        print(name, json.dumps(turn(trees[key])), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
