"""Time ways of adding bf16 gradients into fp32 sums (the step of
``train.grad_accum`` after each microbatch) on one NVIDIA GPU, in turns.

    python3 -m afft_tpu_torch.tools.accum_turns \
        [--expt 01_SA-Fuser_ek100_train.txt]

Random bf16 tensors of the expt's parameter shapes are added into fp32
tensors of the same shapes: (a) an fp32 copy through one flat buffer, then
one multi-tensor add; (b) the same a 256 MB bucket at a time; (c) one flat
bf16 copy added into one flat fp32 sum; (d) one multi-tensor add of the
bf16 tensors themselves. Each turn times 5 calls with CUDA events (device
ms) and the host clock (host ms); the turns run a, b, c, d, d, c, b, a
three times, and the medians are printed as one JSON object beside the
card's name and power limit, with each way's transient device memory.
Imports torch and afft_tpu_torch only.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--expt", default="01_SA-Fuser_ek100_train.txt")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch
    from afft_tpu_torch import serve
    from afft_tpu_torch.models import BaseModel
    from afft_tpu_torch.parallel import mesh
    from afft_tpu_torch.train import optim as O

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    cfg = serve.load_config(os.path.join(REPO, "expts", args.expt))
    with torch.device("meta"):
        model = BaseModel(cfg.model, num_classes={
            "action": 3806, "verb": 97, "noun": 300})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    bf = [torch.randn(p.shape, device="cuda", generator=gen).bfloat16()
          for p in model.parameters()]
    flat, acc = O.upcast(bf)

    def a_upcast_foreach():
        torch._foreach_add_(acc, O.upcast(bf)[1])

    def b_bucketed():
        into = {id(t): x for t, x in zip(bf, acc)}
        for bucket in mesh.buckets(bf, mesh.GRAD_BUCKET):
            torch._foreach_add_([into[id(t)] for t in bucket],
                                O.upcast(bucket)[1])

    def c_cat_add():
        flat.add_(torch.cat([t.reshape(-1) for t in bf]))

    def d_mixed_foreach():
        torch._foreach_add_(acc, bf)

    fns = [a_upcast_foreach, b_bucketed, c_cat_add, d_mixed_foreach]
    for f in fns:
        f()
        f()
    res = {f.__name__: {"device_ms": [], "host_ms": []} for f in fns}
    for _ in range(3):
        for f in fns + fns[::-1]:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(5):
                f()
            end.record()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            res[f.__name__]["device_ms"].append(start.elapsed_time(end) / 5)
            res[f.__name__]["host_ms"].append((t1 - t0) * 1e3 / 5)
    out = {}
    for f in fns:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        f()
        torch.cuda.synchronize()
        out[f.__name__] = {
            **{k: statistics.median(v) for k, v in res[f.__name__].items()},
            "transient_GB": (torch.cuda.max_memory_allocated() - base) / 1e9}
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
