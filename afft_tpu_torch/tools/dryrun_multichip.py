"""The port's multi-process dry run: every parallel layout of the training
step on N processes, the counterpart of ``__graft_entry__.py``
``dryrun_multichip`` (:72-322).

    python -m afft_tpu_torch.tools.dryrun_multichip -n 8 [--device cpu]

N processes are spawned once (torch.multiprocessing, a gloo process group
on ``tcp://localhost`` at a free port), and every mode runs inside them on
grids over some or all of them (``parallel.mesh.Grid``), in the JAX
driver's order:

- pure-DP: the N processes as data replicas;
- 2-D data x model2 (N even, N >= 4): tensor parallelism over model ranks
  (``parallel.sharding.make_mesh_2d``), and the same with sequence
  parallelism (``SeqCtx``);
- DP + ZeRO-1 (``train.zero_sharding``) and DP x ``train.grad_accum=2``;
- the GPipe schedule: the GPT-2 training layers (2·S layers, C 32, 2 heads,
  B 2·S, T 6, dropout 0) on S = min(4, N) of the processes against the
  sequential stack, sum(out²) within rtol 1e-4 and finite gradients;
- data x pipe2 (N even, N >= 4, ``train.pipeline_stages=2``);
- 3-axis data x model2 x pipe2 (N divisible by 8,
  ``parallel.sharding.make_mesh_3d``), its first loss on B = 16 within rtol
  1e-3 of one process's on the same batch (process 0 alone, the same
  program unsharded).

The modes that run the pure-DP program on its global batch under another
layout (2-D with and without SP, ZeRO-1, data x pipe2) must also give its
first loss within rtol 1e-3 (beyond the JAX driver, which prints them).

Each train mode builds the JAX driver's tiny config (modalities rgb 32,
objects 16, flow 32; common_dim 32, the GPT-2 predictor at 64 wide with 2
layers of 2 heads, a 2-block SA-Fuser of 2 heads, nesterov SGD, mixup on,
13 action classes) from the port's config, draws its weights from the
config's seed, and takes two steps on a global batch of B = 2·N rows (16 in
the 3-axis mode) of T = 6 made with numpy from seed 0, each replica its
own rows. Process 0 prints one line per mode, as the JAX driver does.

Without ``--device cpu`` every process runs on the card (all of them on
``cuda:0`` of a one-card machine, over gloo: the collectives move through
host memory). Imports torch and afft_tpu_torch only.
"""

from __future__ import annotations

import argparse
import logging
import os
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# the JAX driver's tiny config (__graft_entry__.py:240-249) and classes
TINY = ["model.modal_dims={rgb: 32, objects: 16, flow: 32}",
        "model.common_dim=32", "model.common.fp_inter_dim=64",
        "model.common.fp_layers=2", "model.common.fp_heads=2",
        "model.fuser.depth=2", "model.fuser.num_heads=2",
        "opt.optimizer.nesterov=true"]
CLASSES = {"action": 13}
T = 6
LOSS_RTOL = 1e-3        # the 3-axis loss against one process
STACK_RTOL = 1e-4       # the GPipe schedule against the sequential stack


def make_batch(cfg, B: int):
    """The JAX driver's global batch (__graft_entry__.py:282-292)."""
    rng = np.random.default_rng(0)
    dims = cfg.model.modal_dims.to_container()
    return {"data_dict": {m: rng.standard_normal((B, T, d)).astype(np.float32)
                          for m, d in dims.items()},
            "target": {"action": rng.integers(0, 13, (B,))},
            "target_subclips": {"action": rng.integers(-1, 13, (B, T, 1))},
            "valid": np.ones((B,), bool)}


def _rows(batch, replica: int, replicas: int):
    def take(v):
        if isinstance(v, dict):
            return {k: take(x) for k, x in v.items()}
        n = len(v) // replicas
        return v[replica * n:(replica + 1) * n]
    return {k: take(v) for k, v in batch.items()}


def train_mode(n: int, device, grid, overrides=(), B=None,
               seq_parallel=False):
    """Two train steps of the tiny config on ``grid`` (None: the world as
    data replicas); returns the (first, second) total losses on the grid's
    processes, None elsewhere."""
    from ..config import CONF_DIR, compose
    from ..parallel import mesh
    from ..train.runner import Runner
    cfg = compose(CONF_DIR, TINY + list(overrides))
    if grid is not None and not grid.member:
        return None
    runner = Runner.from_config(
        cfg, CLASSES, device=device, grid=grid, seq_parallel=seq_parallel,
        world_size=(grid or mesh.grid(1)).replicas)
    batch = make_batch(cfg, B or 2 * n)
    local = _rows(batch, runner.grid.data, runner.grid.replicas)
    losses = []
    for _ in range(2):
        step, _ = runner.train_step(local, 1e-3, 1e-3)
        losses.append(float(step["total_loss"]))
        if not np.isfinite(losses[-1]):
            raise AssertionError(f"non-finite loss {losses[-1]}")
    return losses


def stack_mode(n: int, device) -> str:
    """The GPipe schedule on S = min(4, n) processes against the sequential
    stack (__graft_entry__.py:162-200)."""
    from ..models import layers as L
    from ..models.predictor import BaseFuturePredictor
    from ..parallel import mesh
    from ..parallel import pipeline as P
    stages = min(4, n)
    layers, B, C, heads = 2 * stages, 2 * stages, 32, 2
    grid = mesh.Grid(stages, 1, ranks=range(stages))
    if not grid.member:
        return ""
    pred = BaseFuturePredictor(C, inter_dim=C, n_layer=layers, n_head=heads,
                               embd_pdrop=0.0, resid_pdrop=0.0,
                               attn_pdrop=0.0).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    pred.reset_parameters(gen)
    pred.train()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (B, T, C)).astype(np.float32)).to(device)
    mask = L.neg_inf_causal_mask(T, device=x.device)
    with torch.no_grad():
        ref = float((pred._train_layers(x, mask, "kernel", None) ** 2).sum())
    names = [k for k, _ in pred.named_parameters()]
    ctx = P.PipelineCtx(stages, stages, layers, names=names,
                        keys=list(pred.state_dict()), grid=grid)
    pred.pipeline(ctx)
    out = pred._train_layers(x, mask, "kernel", None)
    loss = (out ** 2).sum()
    loss.backward()
    got = float(loss.detach())
    if not np.isclose(got, ref, rtol=STACK_RTOL):
        raise AssertionError(f"pipeline loss {got} != sequential {ref}")
    if not all(bool(p.grad.isfinite().all()) for p in pred.parameters()
               if p.grad is not None):
        raise AssertionError("pipeline: non-finite gradients")
    return f"pipeline {stages}-stage {layers}-layer): ok, loss match {got:.4f}"


def _say(rank: int, n: int, mode: str, losses, same_as=None) -> None:
    """Process 0's line for a mode; ``same_as``: pure-DP's losses, which
    the mode's first loss must match."""
    if rank != 0:
        return
    if same_as is not None and not np.isclose(losses[0], same_as[0],
                                              rtol=LOSS_RTOL):
        raise AssertionError(f"{mode}: first loss {losses[0]} != pure-DP's "
                             f"{same_as[0]}")
    print(f"dryrun_multichip({n}, {mode}): ok, loss={losses[0]:.4f} -> "
          f"{losses[1]:.4f}", flush=True)


def run_modes(n: int, device) -> None:
    """Every mode, in the JAX driver's order, on this process."""
    from ..parallel import mesh
    from ..parallel.sharding import make_mesh_2d, make_mesh_3d
    rank = dist.get_rank()
    dp = train_mode(n, device, None)
    _say(rank, n, "pure-DP", dp)
    if n % 2 == 0 and n >= 4:
        grid = make_mesh_2d(n // 2, 2)
        _say(rank, n, f"2-D data{n // 2}xmodel2",
             train_mode(n, device, grid), dp)
        _say(rank, n, f"2-D data{n // 2}xmodel2+SP",
             train_mode(n, device, grid, seq_parallel=True), dp)
    _say(rank, n, "DP+ZeRO-1",
         train_mode(n, device, None, ["train.zero_sharding=true"]), dp)
    _say(rank, n, "pure-DP x grad_accum=2",
         train_mode(n, device, None, ["train.grad_accum=2"]))
    said = stack_mode(n, device)
    if rank == 0:
        print(f"dryrun_multichip({n}, {said}", flush=True)
    pipe = ["train.pipeline_stages=2", "train.pipeline_microbatches=2"]
    if n % 2 == 0 and n >= 4:
        _say(rank, n, f"data{n // 2}xpipe2 (train.pipeline_stages)",
             train_mode(n, device, mesh.grid(2), pipe), dp)
    if n % 8 == 0:
        # the same program on process 0 alone, then on the 3-axis grid
        ref = train_mode(n, device, mesh.Grid(1, 1, ranks=[0]), B=16)
        got = train_mode(n, device, make_mesh_3d(n // 4, 2, 2), pipe, B=16)
        if rank == 0:
            print(f"dryrun_multichip(1, 3-axis single-device reference): ok, "
                  f"loss={ref[0]:.4f} -> {ref[1]:.4f}", flush=True)
            _say(rank, n, f"3-axis data{n // 4}xmodel2xpipe2", got)
            if not np.isclose(got[0], ref[0], rtol=LOSS_RTOL):
                raise AssertionError(f"3-axis loss {got[0]} != "
                                     f"single-device {ref[0]}")
            print(f"dryrun_multichip({n}, 3-axis data x model x pipe): "
                  f"loss matches single-device ({got[0]:.6f} vs "
                  f"{ref[0]:.6f})", flush=True)
    dist.barrier()


def _worker(rank: int, n: int, port: int, device: str) -> None:
    from .. import resolve_device
    from ..parallel import mesh
    torch.set_num_threads(1)
    if rank != 0:
        logging.getLogger().setLevel(logging.ERROR)
    dev = resolve_device(device)
    if dev.type == "cuda":
        # every process on the one card it is given (or the first): gloo
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=n, rank=rank, timeout=mesh.TIMEOUT)
    try:
        run_modes(n, dev)
    finally:
        mesh.shutdown()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-n", type=int, default=8, help="processes (default 8)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: every process on the card) or "
                         "cpu")
    args = ap.parse_args(argv)
    from .. import resolve_device
    resolve_device(args.device)
    if args.n < 1:
        raise ValueError(f"-n {args.n}: one process or more")
    mp.start_processes(_worker, args=(args.n, _free_port(), args.device),
                       nprocs=args.n, join=True, start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
