#!/usr/bin/env python3
"""Where the host waits in a training step of the PyTorch/CUDA port, with
host batches copied from pinned memory (as ``Runner._to_device`` copies
them) and with the batch already on the card.

    python3 tools/torch_train_host_trace.py [--batch 64 256] [--steps 12]

Runs on one NVIDIA GPU: the flagship training step
(expts/01_SA-Fuser_ek100_train.txt, bf16 over fp32 masters, seeded
weights, synthetic EK100-shaped numpy batches as the loader gives them) at
each batch size. Each copy mode runs ``--steps`` steps without a host
synchronisation, in turns (pinned, on the card, pinned), and prints per
turn the median host time of a step's call (the enqueue, which a full
launch queue paces at the card's speed) and the median step time between
CUDA events; then per mode the host time of a
step's call with an empty queue (synchronised before and after, median of
5): below the step time, the card is the bound; above it, the host. Then
one step of each mode is profiled
(torch.profiler, CPU and CUDA) and the host calls that wait on the device
or copy (``cudaStreamSynchronize``, ``cudaMemcpyAsync``,
``aten::_local_scalar_dense``, ...) are listed with their host time, with
the top host ops by self time. Imports torch and afft_tpu_torch only.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPT = os.path.join(REPO, "expts", "01_SA-Fuser_ek100_train.txt")
CLASSES = {"action": 3806, "verb": 97, "noun": 300}
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpyAsync", "cudaMemcpy",
         "cudaHostAlloc", "cudaMalloc", "cudaFree",
         "aten::_local_scalar_dense", "aten::item", "aten::nonzero",
         "aten::pin_memory", "aten::copy_")


def host_batch(cfg, batch, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    T = int(cfg.data_train.num_frames)
    return {
        "data_dict": {m: rng.standard_normal((batch, T, int(d)),
                                             dtype=np.float32)
                      for m, d in cfg.model.modal_dims.to_container()
                      .items()},
        "target": {t: rng.integers(0, c, batch) for t, c in CLASSES.items()},
        "target_subclips": {t: rng.integers(0, c, (batch, T, 1))
                            for t, c in CLASSES.items()},
        "valid": np.ones(batch, bool)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, nargs="+", default=[64, 256])
    ap.add_argument("--steps", type=int, default=12)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("error: CUDA is not available; this tool measures the card")
    sys.path.insert(0, REPO)
    from afft_tpu_torch import serve
    from afft_tpu_torch.train.runner import Runner

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cfg = serve.load_config(EXPT)
    runner = Runner.from_config(cfg, CLASSES, device="cuda",
                                iters_per_epoch=1, compute_dtype="bfloat16")
    for batch in args.batch:
        print(json.dumps({"batch": batch, **trace(runner, cfg, batch,
                                                  args.steps)}), flush=True)


def trace(runner, cfg, batch, steps):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    host = [host_batch(cfg, batch, s) for s in range(4)]
    on_card = [{k: ({kk: torch.as_tensor(vv).cuda() for kk, vv in v.items()}
                    if isinstance(v, dict) else torch.as_tensor(v).cuda())
                for k, v in b.items()} for b in host]

    def set_mode(mode):
        return on_card if mode == "on_card" else host

    lr = float(cfg.opt.lr)
    results = []
    for mode in ("pinned", "on_card", "pinned"):
        batches = set_mode(mode)
        host_ms, events = [], []
        for i in range(steps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            runner.train_step(batches[i % len(batches)], lr, lr)
            end.record()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            events.append((start, end))
        torch.cuda.synchronize()
        tail = steps * 2 // 3
        row = {"mode": mode,
               "host_enqueue_ms": statistics.median(host_ms[-tail:]),
               "step_ms": statistics.median(a.elapsed_time(b)
                                            for a, b in events[-tail:])}
        results.append(row)
        print(json.dumps({"batch": batch, **row}), flush=True)
    cold = {}
    for mode in ("pinned", "on_card"):
        batches = set_mode(mode)
        times = []
        for i in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner.train_step(batches[i % len(batches)], lr, lr)
            times.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        cold[mode] = statistics.median(times)

    traces = {}
    for mode in ("pinned", "on_card"):
        batches = set_mode(mode)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            runner.train_step(batches[0], lr, lr)
            host_s = time.perf_counter() - t0
            torch.cuda.synchronize()
        avg = prof.key_averages()
        waits = {e.key: {"calls": e.count,
                         "host_ms": e.self_cpu_time_total / 1e3}
                 for e in avg if e.key in WAITS}
        top = sorted(avg, key=lambda e: -e.self_cpu_time_total)[:8]
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        traces[mode] = {
            "host_ms_of_the_call": host_s * 1e3,
            "device_kernels": len(kernels),
            "device_busy_ms": sum(e.time_range.elapsed_us()
                                  for e in kernels) / 1e3,
            "waits": waits,
            "top_host_ops": [(e.key, round(e.self_cpu_time_total / 1e3, 3))
                             for e in top]}
        print(json.dumps({"batch": batch, "profile": mode, **traces[mode]}),
              flush=True)
    return {"turns": results, "host_ms_empty_queue": cold,
            "profiles": traces}


if __name__ == "__main__":
    main()
