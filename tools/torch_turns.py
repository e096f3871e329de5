#!/usr/bin/env python3
"""Two trees of the PyTorch/CUDA port in turns on one NVIDIA GPU: one
workload's numbers for the parent and a change, measured in one call.

    python3 tools/torch_turns.py startup PARENT_DIR CHANGE_DIR \\
        [--order pccppccp]
    python3 tools/torch_turns.py serve PARENT_DIR CHANGE_DIR \\
        [--expt 01_SA-Fuser_ek100_val_Swin.txt] \\
        [--override model.common.fp_output_len=4] [--order pccppc]
    python3 tools/torch_turns.py long PARENT_DIR CHANGE_DIR [--order pccp]
    python3 tools/torch_turns.py train PARENT_DIR CHANGE_DIR [--order pccp]
    python3 tools/torch_turns.py drops PARENT_DIR CHANGE_DIR [--order pccp]
    python3 tools/torch_turns.py bits PARENT_DIR CHANGE_DIR

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
* ``train``: the flagship's training step (expt 01, batch 256, bf16 over
  fp32 masters, seeded weights, synthetic batches): ``--iters`` steps after
  three warm-up steps, each timed with CUDA events; their ms and median.
* ``drops``: the drop passes at the flagship's shapes in bf16: the mask
  kernels of rows 10 and 16 (``draw_masks``, ``draw_masks_gpt2``; CUDA
  events a call, as ``chip_smoke.py`` times them, and their device time
  from the profiler) and the backward entries' ``drop_grad`` (device time
  a launch from the profiler over ``--iters`` calls of both backward
  entries of each layer: no tree before this tool's has a wrapper for it).
* ``bits``: every training entry's outputs and gradients (rows 7-9 and
  11-15 through autograd at the flagship's widths, in bf16 and fp32, short
  and long attention routes, and the shard mode's partial sums, dy, dx and
  gradients at tp = 2 rank by rank) and both mask kernels' masks, one
  SHA-256 a tensor from one process a tree; the tool then lists the tensors
  whose bits differ between the trees. Each tree's ``chip_smoke.py`` gives
  its parameters and rates.

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

TRAIN = r'''
import json, os, statistics, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as S
from afft_tpu_torch import serve
from afft_tpu_torch.train.runner import Runner
args = json.loads(sys.argv[1])
cfg = serve.load_config(os.path.join("expts", S.TRAIN_EXPT))
torch.manual_seed(0)
runner = Runner.from_config(cfg, S.TRAIN_CLASSES, device="cuda",
                            iters_per_epoch=1, compute_dtype="bfloat16")
batches = S.synthetic_batches(cfg, S.TRAIN_BATCH, 4, seed=2)
warmup = int(cfg.opt.warmup.num_epochs)
events = []
for i in range(3 + args["iters"]):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    runner.train_step(batches[i % len(batches)],
                      runner.lr_schedule(warmup + i, runner.base_lr),
                      runner.base_lr)
    end.record()
    events.append((start, end))
torch.cuda.synchronize()
ms = [a.elapsed_time(b) for a, b in events[3:]]
print(json.dumps({"step_ms": ms, "median_ms": statistics.median(ms)}))
'''

DROPS = r'''
import json, os, sys
sys.path.insert(0, os.getcwd())
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as S
from afft_tpu_torch.models.layers import neg_inf_causal_mask
from afft_tpu_torch.ops import fused_block_train as FT
from afft_tpu_torch.ops import fused_gpt2_train as FGT
args = json.loads(sys.argv[1])
gen = torch.Generator(device="cuda")
gen.manual_seed(3)
rn = S._randn(gen, torch.bfloat16)


def device_ms(fn, names, iters):
    """Device ms a launch of the kernels whose names hold one of
    ``names`` over ``iters`` calls of fn, from the profiler."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if any(n in e.key for n in names):
            total += getattr(e, "device_time_total", None) or \
                e.cuda_time_total
            count += e.count
    return (total / 1e3 / count if count else None), count


out = {}
mask_names = ("fill_mask",)
for label, fn in (
        ("10 draw_masks", lambda: FT.draw_masks(
            4096, 5, 1024, 4, S.TRAIN_SEEDS, 5, *S.TRAIN_RATES.values())),
        ("16 draw_masks_gpt2", lambda: FGT.draw_masks_gpt2(
            256, 16, 2048, 4, S.TRAIN_SEEDS, 3, *S.GPT2_RATES.values()))):
    ms, n = device_ms(fn, mask_names, args["iters"])
    out[label] = {"ms": S.time_ms(fn), "device_ms_a_launch": ms,
                  "launches_a_call": n / args["iters"]}
for label, shape, kernel in (
        ("fuser", (4096, 5, 1024), lambda x, p: FT.fused_block_train(
            x, p, None, S.TRAIN_SEEDS, num_heads=4, block_idx=5,
            **S.TRAIN_RATES)),
        ("gpt2", (256, 16, 2048), lambda x, p: FGT.fused_gpt2_block_train(
            x, p, neg_inf_causal_mask(16, device="cuda"), S.TRAIN_SEEDS,
            num_heads=4, layer_idx=3, **S.GPT2_RATES))):
    R, N, C = shape
    p = (S.block_params(C, 4 * C, torch.bfloat16, gen) if label == "fuser"
         else S.gpt2_params(C, 4 * C, torch.bfloat16, gen))
    x, dout = rn(R, N, C), rn(R * N, C)
    xk = x.clone().requires_grad_(True)
    o = kernel(xk, {k: v.clone().requires_grad_(True) for k, v in p.items()})
    saved = o.grad_fn.saved_tensors
    y, qkv, pre1, mask32 = saved[1:5]
    tensors, cfg = list(saved[5:]), o.grad_fn.cfg
    grads = FT.new_grads(tensors)
    dy = FT.block_train_bwd_mlp(x, y, dout, pre1, tensors, grads, cfg)

    def both():
        FT.block_train_bwd_mlp(x, y, dout, pre1, tensors, grads, cfg)
        FT.block_train_bwd_attn(x, dy, qkv, mask32, tensors, grads, cfg)
    ms, n = device_ms(both, ("drop_grad",), args["iters"])
    out[f"drop_grad {label}"] = {"device_ms_a_launch": ms,
                                 "launches_a_call": n / args["iters"]}
    del o, saved, y, qkv, pre1, tensors, grads, dy
    torch.cuda.empty_cache()
print(json.dumps(out))
'''

BITS = r'''
import hashlib, json, os, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as S
from afft_tpu_torch.models.layers import neg_inf_causal_mask
from afft_tpu_torch.ops import fused_block as FB
from afft_tpu_torch.ops import fused_block_train as FT
from afft_tpu_torch.ops import fused_gpt2_train as FGT
from afft_tpu_torch.ops._common import Shard
out = {}


def keep(prefix, tensors):
    torch.cuda.synchronize()
    for i, t in enumerate(tensors):
        if t is not None:
            b = t.detach().contiguous().view(torch.uint8).cpu().numpy()
            out[f"{prefix}.{i}"] = hashlib.sha256(b.tobytes()).hexdigest()


def grads(fn, x, p, dout):
    xk = x.clone().requires_grad_(True)
    pk = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    o = fn(xk, pk)
    o.backward(dout)
    return [o, xk.grad] + [pk[k].grad for k in sorted(pk)]


def shard_run(gpt2, x, p, dout, H, hidden, dt, prefix):
    """The three entries in shard mode at tp = S.TP, rank by rank (no
    process group), as chip_smoke.py's check_tp_layer drives them."""
    R, N, C = x.shape
    dflat = dout.reshape(R * N, C)
    if gpt2:
        rates, mask = S.GPT2_RATES, neg_inf_causal_mask(N, device="cuda")
        arrays = FT.rate_arrays(S.TRAIN_SEEDS, 3, rates["attn_rate"],
                                rates["resid_rate"], 0.0)
        layer, heads, eps = FGT.GPT2, H // S.TP, 1e-5
    else:
        mask = None
        arrays = FT.rate_arrays(S.TRAIN_SEEDS, 5, *S.TRAIN_RATES.values())
        layer, heads, eps = FT.FUSER, H, 1e-6
    mask32 = None if mask is None else mask.float().contiguous()
    cfg = (heads, hidden // S.TP, eps, arrays, layer)
    ranks = []
    for m in range(S.TP):
        pm = S._tp_local(p, prefix, m)
        name = "fused_gpt2_train" if gpt2 else "fused_block_train"
        t = (FGT.gpt2_operands(name, x, pm, heads, S.TP)[0] if gpt2 else
             FB.block_operands(name, x, pm, H, differentiable=True)[0])
        ranks.append((t, Shard(m, S.TP)))
    runs = []
    if gpt2:
        ysum = None
        for t, sh in ranks:
            a = FT.train_fwd_shard(x, mask32, cfg, t, sh, FT.PART_ATTN)
            ysum = a["part"] if ysum is None else ysum + a["part"]
            runs.append(a)
        y = ysum.to(dt)
        for (t, sh), a in zip(ranks, runs):
            b = FT.train_fwd_shard(x, mask32, cfg, t, sh, FT.PART_MLP, y)
            a.update(mlp_part=b["part"], pre1=b["pre1"], y=y)
    else:
        for t, sh in ranks:
            runs.append(FT.train_fwd_shard(x, mask32, cfg, t, sh,
                                           FT.PART_BOTH))
    res, gs, dysum = [], [], None
    for (t, sh), a in zip(ranks, runs):
        res += [a["part"], a.get("mlp_part"), a.get("qkv"), a.get("pre1"),
                a.get("y")]
        g = FT.new_grads(t)
        dy = FT.block_train_bwd_mlp(x, a["y"], dflat, a["pre1"], t, g, cfg,
                                    sh)
        res.append(dy)
        gs.append(g)
        dysum = dy if dysum is None else dysum + dy
    dy = dysum.to(dt)
    for k, ((t, sh), a) in enumerate(zip(ranks, runs)):
        if gpt2:
            res.append(FT.block_train_bwd_attn(x, dy, a["qkv"], mask32, t,
                                               gs[k], cfg, sh))
        elif k == 0:
            res.append(FT.block_train_bwd_attn(x, dy, a["qkv"], mask32, t,
                                               gs[k], cfg))
        res += gs[k]
    return res


gen = torch.Generator(device="cuda")
gen.manual_seed(5)
for tag, dt, R, B in (("bf16", torch.bfloat16, 4096, 256),
                      ("fp32", torch.float32, 512, 32)):
    rn = S._randn(gen, dt)
    # the fuser block (rows 7-9) at 5 tokens, and at 12 (the long route)
    for N, rows in ((5, R), (12, R // 8)):
        p = S.block_params(1024, 4096, dt, gen)
        x, d = rn(rows, N, 1024), rn(rows, N, 1024)
        keep(f"fuser {tag} N {N}", grads(
            lambda x, p: FT.fused_block_train(
                x, p, None, S.TRAIN_SEEDS, num_heads=4, block_idx=5,
                **S.TRAIN_RATES), x, p, d))
        if N == 5:
            keep(f"fuser {tag} shard", shard_run(
                False, x, p, d, 4, 4096, dt, "fuser.blocks.5."))
        keep(f"fuser {tag} masks N {N}", FT.draw_masks(
            rows, N, 1024, 4, S.TRAIN_SEEDS, 5, *S.TRAIN_RATES.values()))
        del p, x, d
    # the GPT-2 layer (rows 11-15) at 16 tokens, and at 48 (the long route)
    for T, rows in ((16, B), (48, B // 8)):
        g = S.gpt2_params(2048, 8192, dt, gen)
        x, d = rn(rows, T, 2048), rn(rows, T, 2048)
        mask = neg_inf_causal_mask(T, device="cuda")
        keep(f"gpt2 {tag} T {T}", grads(
            lambda x, p: FGT.fused_gpt2_block_train(
                x, p, mask, S.TRAIN_SEEDS, num_heads=4, layer_idx=3,
                **S.GPT2_RATES), x, g, d))
        if T == 16:
            keep(f"gpt2 {tag} shard", shard_run(
                True, x, g, d, 4, 8192, dt, "gpt_model.h.3."))
        keep(f"gpt2 {tag} masks T {T}", FGT.draw_masks_gpt2(
            rows, T, 2048, 4, S.TRAIN_SEEDS, 3, *S.GPT2_RATES.values()))
        del g, x, d
    torch.cuda.empty_cache()
with open(json.loads(sys.argv[1])["out"], "w") as f:
    json.dump(out, f)
print(json.dumps({"tensors": len(out)}))
'''

WORKLOADS = {"startup": (STARTUP, "pccppccp"), "serve": (SERVE, "pccppc"),
             "long": (LONG, "pccp"), "train": (TRAIN, "pccp"),
             "drops": (DROPS, "pccp"), "bits": (BITS, "pc")}
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
    ap.add_argument("--iters", type=int, default=10,
                    help="serve, train, drops")
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
    hashes = {}
    for i, key in enumerate(args.order or order):
        child_args["out"] = os.path.join(trees[key], "build",
                                         f"bits_{i}.json")
        record = turn(trees[key], child, child_args)
        print(json.dumps({"turn": i, "tree": key, **record}), flush=True)
        if args.workload == "bits":
            with open(child_args["out"]) as f:
                hashes[key] = json.load(f)
    if args.workload == "bits":
        p, c = hashes["p"], hashes["c"]
        differ = sorted(k for k in p if p[k] != c.get(k))
        print(json.dumps({"bits": {
            "tensors": len(p), "same_names": set(p) == set(c),
            "differ": differ, "equal": not differ and set(p) == set(c)}}))
        return 0 if not differ and set(p) == set(c) else 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
