"""Data-parallel checks: the jobs that hold a run on several processes
against one process.

Run under torchrun (every process runs the same jobs), or call a job's
function in one process for the reference:

    python -m torch.distributed.run --standalone --nproc_per_node=2 \\
        -m afft_tpu_torch.tools.dp_check SPEC.json

SPEC.json: {"device": "cpu" | "cuda" | "cuda:K", "out": directory, "jobs":
[job, ...]}. Each job writes ``<out>/<name>.rank<r>.pt`` (torch.save of a
dict) on every rank:

- ``{"kind": "train", "name", "expt", "overrides", "classes", "batch",
  "steps", "seed", "lrs", "weights": state-dict file or null, "lam": [λ a
  step] or null, "invalid": [global rows whose valid is False]}``:
  ``Runner.train_step`` on ``steps`` global batches of ``batch`` rows made
  from ``seed``; each rank takes its contiguous share (``batch / world``
  rows). Writes the losses of every step, each step's host time to its
  end (the device synchronised), the final state dict (rank 0, unless
  ``"keep_state": false``) and the kernel launches of this rank.
- ``{"kind": "eval", "name", "expt", "overrides", "batch", "seed"}``: the
  expt's eval set through ``eval.evaluate.collect_logits`` on this rank's
  shard, merged over the ranks, and through the whole set on every rank.
- ``{"kind": "meters", "name", "classes", "ckpt_dir"}``: a
  ``MetricTracker`` fed rank-dependent values and synchronised, and
  ``save_checkpoint`` into ``ckpt_dir`` (only rank 0 writes).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..config import CONF_DIR, compose, read_expt_file
from ..ops import launch_counts, reset_launches
from ..parallel import mesh


def make_batches(cfg, classes, batch: int, steps: int, seed: int,
                 invalid=()):
    """``steps`` global batches of ``batch`` rows (numpy; features
    N(0, 1), labels uniform, one row of each with ignored past frames, the
    rows in ``invalid`` padding)."""
    rng = np.random.default_rng(seed)
    T = int(cfg.data_train.num_frames)
    dims = cfg.model.modal_dims.to_container()
    out = []
    for _ in range(steps):
        sub = {t: rng.integers(0, c, (batch, T, 1))
               for t, c in classes.items()}
        for t in sub:
            sub[t][min(1, batch - 1), :3] = -1
        valid = np.ones((batch,), bool)
        valid[list(invalid)] = False
        out.append({
            "data_dict": {m: rng.standard_normal((batch, T, int(d)))
                          .astype(np.float32) for m, d in dims.items()},
            "target": {t: rng.integers(0, c, (batch,))
                       for t, c in classes.items()},
            "target_subclips": sub, "valid": valid})
    return out


def shard(batch, rank: int, world: int):
    """This rank's contiguous rows of a global batch."""
    def take(v):
        if isinstance(v, dict):
            return {k: take(x) for k, x in v.items()}
        if v is None or np.ndim(v) == 0:
            return v
        rows = len(v) // world
        return v[rank * rows:(rank + 1) * rows]
    return {k: take(v) for k, v in batch.items()}


def _cfg(job):
    return compose(CONF_DIR, read_expt_file(job["expt"]) +
                   list(job.get("overrides", ())))


def run_train(job, device):
    """The ``train`` job on this process (a rank's share, or the whole
    batch without a process group); returns its record."""
    from ..train.runner import Runner
    rank, world = mesh.rank_and_world()
    cfg = _cfg(job)
    classes = job["classes"]
    if job["batch"] % world:
        raise ValueError(f"batch {job['batch']} over {world} processes")
    weights = None
    if job.get("weights"):
        weights = torch.load(job["weights"], map_location="cpu")
    runner = Runner.from_config(cfg, classes, device=device,
                                iters_per_epoch=2, world_size=world,
                                weights=weights)
    batches = make_batches(cfg, classes, job["batch"], job["steps"],
                           job["seed"], job.get("invalid", ()))
    cuda = runner.device.type == "cuda"
    reset_launches()
    losses, step_ms = [], []
    for i, batch in enumerate(batches):
        local = shard(batch, rank, world)
        if job.get("lam") is not None:
            local["mixup_lam"] = np.float32(job["lam"][i])
        t0 = time.perf_counter()
        step, _ = runner.train_step(local, job["lrs"][i], runner.base_lr,
                                    check_nan=True)
        losses.append({k: float(v) for k, v in step.items()})
        if cuda:
            torch.cuda.synchronize(runner.device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return {"losses": losses, "launches": launch_counts(), "rank": rank,
            "world": world, "step_ms": step_ms,
            "state": {k: v.detach().cpu() for k, v in
                      runner.model.state_dict().items()}
            if rank == 0 and job.get("keep_state", True) else None}


def run_eval(job, device):
    """The ``eval`` job: (merged shards, the whole set) logits and row
    indices."""
    from ..data.loader import BatchLoader, get_dataset
    from ..eval.evaluate import _forward_all, collect_logits
    from ..train.loop import DATASET_EVAL_CFG_KEY, get_transforms
    from ..train.runner import Runner
    rank, world = mesh.rank_and_world()
    cfg = _cfg(job)
    dataset = get_dataset(cfg[DATASET_EVAL_CFG_KEY], cfg.data_eval,
                          get_transforms(cfg, train=False))
    classes = {k: len(v) for k, v in dataset.classes.items()}
    runner = Runner.from_config(cfg, classes, device=device,
                                class_mappings=dataset.class_mappings)
    sharded = BatchLoader(dataset, batch_size=job["batch"], shuffle=False,
                          num_workers=1, shard_id=rank, num_shards=world)
    logits, idx, _ = collect_logits(runner, sharded)
    # every rank forwards the whole set too (its steps all-reduce their
    # loss denominators, so all ranks take them together)
    whole = BatchLoader(dataset, batch_size=job["batch"], shuffle=False,
                        num_workers=1)
    parts = list(_forward_all(runner, whole))
    return {"merged": logits, "merged_idx": idx,
            "whole": np.concatenate([p[0] for p in parts]),
            "whole_idx": np.concatenate([p[2] for p in parts]),
            "uids": np.concatenate([p[1] for p in parts]), "rank": rank}


def meter_updates(rank: int, classes):
    """The rank's updates of the ``meters`` job: (name, value, n) of an
    average meter and (name, scores, labels) of an MT5R meter."""
    rng = np.random.default_rng(100 + rank)
    n = 5 + 3 * rank
    C = classes["action"]
    return ([("loss", float(rng.random()), n), ("T Step", 0.5 * rank, n)],
            [("mt5r_action_x", rng.standard_normal((n, C)),
              rng.integers(0, C, n))])


def run_meters(job, device):
    from ..train import checkpoint as CK
    from ..train.metrics import MetricTracker
    rank, world = mesh.rank_and_world()
    tracker = MetricTracker(job["classes"])
    averages, mt5r = meter_updates(rank, job["classes"])
    for name, value, n in averages:
        tracker.update({name: value}, n, True)
    for name, scores, labels in mt5r:
        tracker.update({name: {"logits": scores, "labels": labels}}, 1, True)
    tracker.synchronize_between_processes(True)
    model = {"w": torch.full((3,), float(rank))}
    CK.save_checkpoint(os.path.join(job["ckpt_dir"], f"from_rank{rank}"),
                       model, {}, 1, 1, 0.0, block=False)
    CK.save_checkpoint(os.path.join(job["ckpt_dir"], "shared"), model, {},
                       1, 1, 0.0, block=True)
    CK.wait_for_pending_saves()
    return {"values": tracker.get_all_data(True), "rank": rank,
            "world": world}


JOBS = {"train": run_train, "eval": run_eval, "meters": run_meters}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    with open(argv[0]) as f:
        spec = json.load(f)
    resolve_device(spec["device"])
    info = mesh.init_distributed(spec["device"])
    os.makedirs(spec["out"], exist_ok=True)
    try:
        for job in spec["jobs"]:
            record = JOBS[job["kind"]](job, info["device"])
            torch.save(record, os.path.join(
                spec["out"], f"{job['name']}.rank{info['rank']}.pt"))
    finally:
        mesh.shutdown()


if __name__ == "__main__":
    main()
