"""Data-parallel checks: the jobs that hold a run on several processes
against one process.

Run under torchrun (every process runs the same jobs), or call a job's
function in one process for the reference:

    python -m torch.distributed.run --standalone --nproc_per_node=2 \\
        -m afft_tpu_torch.tools.dp_check SPEC.json

SPEC.json: {"device": "cpu" | "cuda" | "cuda:K", "out": directory, "jobs":
[job, ...]}. Each job writes ``<out>/<name>.rank<r>.pt`` (torch.save of a
dict, with the process group's ``"backend"``) on every rank:

- ``{"kind": "train", "name", "expt", "overrides", "classes", "batch",
  "steps", "seed", "lrs", "weights": state-dict file or null, "lam": [λ a
  step] or null, "invalid": [global rows whose valid is False]}``:
  ``Runner.train_step`` on ``steps`` global batches of ``batch`` rows made
  from ``seed``; each rank takes its contiguous share (``batch / world``
  rows). Writes the losses of every step (``"norms"``: the gradient and
  parameter norms of ``train.watch_gradients``), each step's host time to its
  end (the device synchronised), the final state dict (rank 0, unless
  ``"keep_state"`` is false, or ``"host"``: held in this process for a
  later job's ``"against"`` and not written), the optimizer-state bytes and
  the kernel launches of this rank. Optional keys: ``"against": name``
  compares rank 0's final state, every element of every tensor, with that
  earlier job's held one (``"state_diffs"``, each tensor's largest
  |difference| by name; ``"state_diff"``, the largest of them, and
  ``"state_scale"``, the held state's max|w|); ``"against_file": path``
  does the same with a state dict saved by another process; ``"save":
  {"path", "after"}`` writes a checkpoint after that many steps (every
  rank takes part: ZeRO-1 and the pipeline's stages gather their state);
  ``"resume": {"path", "after"}`` loads one and
  runs the steps after it; ``"order": R`` (one process, ``grad_accum`` M)
  orders each global batch microbatch-major as R processes split it
  (``microbatch_major``). Under ``train.pipeline_stages`` = S the shares
  are the D = R / S data replicas', the state (and the checkpoint) is the
  unpipelined layout gathered from the stages, and each rank also records
  its stage, replica, parameter names and the sums of its replicated
  weights (``replicated_sums``). ``"tp": T`` (and ``"sp": true``) lays the
  processes out as ``parallel.sharding.make_mesh_3d(R / (T · S), T, S)``:
  tensor parallelism over T model ranks (with sequence parallelism); the
  shares are the replicas', the state is gathered over the model group,
  and each rank records its model rank, the bytes of its parameters
  (``param_bytes``), its launches in shard mode (``tp_launches``) and a
  digest of the bytes of each tensor it holds whole
  (``replicated_digests``: equal on the ranks of a model group).
  ``"plant": "unsummed_norm_grads"`` plants a tensor-parallel fault for the
  checks to catch: the LayerNorm gradients that the sharded layers leave
  partial are not summed over the model group.
- ``{"kind": "eval", "name", "expt", "overrides", "batch", "seed"}``: the
  expt's eval set through ``eval.evaluate.collect_logits`` on this rank's
  shard, merged over the ranks, and through the whole set on every rank.
- ``{"kind": "stack", "name", "stages", "micro", "layers", "batch",
  "tokens", "width", "heads", "weights": state-dict file, "seed"}``: the
  GPT-2 training layers (dropout 0) of a predictor of that size through
  the S-stage GPipe schedule (``parallel.pipeline``) on x (batch, tokens,
  width) N(0, 1) from ``seed``: the output, the input's gradient and this
  stage's parameter gradients of sum(out²).
- ``{"kind": "meters", "name", "classes", "ckpt_dir"}``: a
  ``MetricTracker`` fed rank-dependent values and synchronised, and
  ``save_checkpoint`` into ``ckpt_dir`` (only rank 0 writes).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..config import CONF_DIR, compose, read_expt_file
from ..ops import launch_counts, reset_launches, tp_launch_counts
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


def microbatch_major(batch, ranks: int, chunks: int):
    """A global batch reordered as ``chunks`` microbatches over ``ranks``
    processes form it (``train.grad_accum``): chunk 0 of every rank's
    contiguous share in rank order, then chunk 1, ... One process at
    ``grad_accum=chunks`` over the result takes the step that ``ranks``
    processes take over ``batch``."""
    def take(v):
        if isinstance(v, dict):
            return {k: take(x) for k, x in v.items()}
        if v is None or np.ndim(v) == 0:
            return v
        b = len(v) // (ranks * chunks)
        order = [r * chunks * b + m * b + i for m in range(chunks)
                 for r in range(ranks) for i in range(b)]
        return v[order]
    return {k: take(v) for k, v in batch.items()}


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


# rank 0's final states of the jobs with ``"keep_state": "host"``, by name
_HELD = {}


def _cfg(job):
    return compose(CONF_DIR, read_expt_file(job["expt"]) +
                   list(job.get("overrides", ())))


def run_train(job, device):
    """The ``train`` job on this process (a rank's share, or the whole
    batch without a process group); returns its record."""
    from ..parallel import pipeline as P
    from ..parallel import sharding as SH
    from ..train.runner import Runner, pipeline_stages
    rank, world = mesh.rank_and_world()
    cfg = _cfg(job)
    classes = job["classes"]
    stages, tp = pipeline_stages(cfg.train), int(job.get("tp") or 1)
    grid = SH.make_mesh_3d(world // (tp * stages), tp, stages) if tp > 1 \
        else mesh.grid(stages)
    replica, replicas = grid.data, grid.replicas
    if job["batch"] % replicas:
        raise ValueError(f"batch {job['batch']} over {replicas} replicas")
    weights = None
    if job.get("weights"):
        weights = torch.load(job["weights"], map_location="cpu")
    runner = Runner.from_config(cfg, classes, device=device,
                                iters_per_epoch=2, world_size=replicas,
                                weights=weights,
                                grid=grid if tp > 1 else None,
                                seq_parallel=bool(job.get("sp")))
    if job.get("plant") == "unsummed_norm_grads":
        runner._partial = None
    batches = make_batches(cfg, classes, job["batch"], job["steps"],
                           job["seed"], job.get("invalid", ()))
    cuda = runner.device.type == "cuda"
    first = 0
    if job.get("resume"):
        from ..train import checkpoint as CK
        ckpt = CK.load_checkpoint(job["resume"]["path"])
        runner.load_checkpoint_state(ckpt["model"], ckpt["optimizer"])
        runner.load_rng_state(ckpt["rng"])
        first = job["resume"]["after"]
    reset_launches()
    if cuda:
        torch.cuda.reset_peak_memory_stats(runner.device)
    losses, norms, step_ms = [], [], []
    for i, batch in enumerate(batches):
        if i < first:
            continue
        if job.get("order") and world == 1:
            batch = microbatch_major(batch, job["order"], runner.grad_accum)
        local = shard(batch, replica, replicas)
        if job.get("lam") is not None:
            local["mixup_lam"] = np.float32(job["lam"][i])
        t0 = time.perf_counter()
        step, metrics = runner.train_step(local, job["lrs"][i],
                                          runner.base_lr, check_nan=True)
        losses.append({k: float(v) for k, v in step.items()})
        norms.append({k: float(v) for k, v in metrics.items()
                      if "_norm" in k and not isinstance(v, dict)})
        if cuda:
            torch.cuda.synchronize(runner.device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if job.get("save") and i + 1 == job["save"]["after"]:
            from ..train import checkpoint as CK
            model_state, opt_state = runner.checkpoint_state()
            CK.save_checkpoint(job["save"]["path"], model_state, opt_state,
                               0, i + 1, 0.0, rng_state=runner.rng_state())
            CK.wait_for_pending_saves()
    named = list(runner.model.named_parameters())
    record = {"losses": losses, "norms": norms,
              "launches": launch_counts(), "tp_launches": tp_launch_counts(),
              "rank": rank,
              "world": world, "replicas": replicas, "step_ms": step_ms,
              "state_bytes": runner.optimizer.state_bytes(), "state": None,
              "model_rank": runner.grid.model,
              "param_bytes": sum(p.numel() * p.element_size()
                                 for p in runner.model.parameters()),
              "params": [n for n, _ in named],
              "replicated_sums": [float(p.detach().double().sum())
                                  for n, p in named
                                  if P.layer_of(n) is None]}
    if cuda:
        record["peak_bytes"] = torch.cuda.max_memory_allocated(runner.device)
    if runner.tp is not None:
        record["replicated_digests"] = {n: _digest(p) for n, p in named
                                        if n not in runner.tp.specs}
    if runner.pipeline is not None:
        record.update(stage=runner.pipeline.stage,
                      replica=runner.pipeline.grid.data)
    keep = job.get("keep_state", True)
    against = job.get("against") or job.get("against_file")
    model_state = runner.model_state() if keep or against else None
    if rank == 0 and (keep or against):
        state = {k: v.detach().cpu() for k, v in model_state.items()}
        if against:
            other = _HELD[against] if job.get("against") else torch.load(
                against, map_location="cpu")
            diffs = {k: float((state[k].float() - v.float()).abs().max())
                     for k, v in other.items()}
            record.update(state_diffs=diffs,
                          state_diff=max(diffs.values()),
                          state_scale=max(float(v.float().abs().max())
                                          for v in other.values()))
        if keep == "host":
            _HELD[job["name"]] = state
        elif keep:
            record["state"] = state
    return record


def _digest(t: torch.Tensor) -> str:
    """A digest of the bytes of ``t``."""
    raw = t.detach().contiguous().view(-1).view(torch.uint8).cpu()
    return hashlib.sha1(raw.numpy().tobytes()).hexdigest()


def run_eval(job, device):
    """The ``eval`` job: (merged shards, the whole set) logits and row
    indices."""
    from ..data.loader import BatchLoader, get_dataset
    from ..eval.evaluate import _forward_all, collect_logits
    from ..train.loop import DATASET_EVAL_CFG_KEY, get_transforms
    from ..train.runner import Runner
    rank, _ = mesh.rank_and_world()
    cfg = _cfg(job)
    dataset = get_dataset(cfg[DATASET_EVAL_CFG_KEY], cfg.data_eval,
                          get_transforms(cfg, train=False))
    classes = {k: len(v) for k, v in dataset.classes.items()}
    runner = Runner.from_config(cfg, classes, device=device,
                                class_mappings=dataset.class_mappings)
    if job.get("weights"):
        runner.load_model_state(torch.load(job["weights"],
                                           map_location="cpu"))
    replica, replicas = runner.grid.data, runner.grid.replicas
    sharded = BatchLoader(dataset, batch_size=job["batch"], shuffle=False,
                          num_workers=1, shard_id=replica,
                          num_shards=replicas)
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


def run_stack(job, device):
    """The ``stack`` job: (output, input gradient, this stage's parameter
    gradients by state-dict name) of sum(out²) through the pipelined
    training layers."""
    from ..models import layers as L
    from ..models.predictor import BaseFuturePredictor
    from ..parallel import pipeline as P
    reset_launches()
    C, n_layer = job["width"], job["layers"]
    pred = BaseFuturePredictor(C, inter_dim=C, n_layer=n_layer,
                               n_head=job["heads"], embd_pdrop=0.0,
                               resid_pdrop=0.0, attn_pdrop=0.0).to(device)
    weights = torch.load(job["weights"], map_location="cpu")
    names = [n for n, _ in pred.named_parameters()]
    ctx = P.PipelineCtx(job["stages"], job["micro"], n_layer, names=names,
                        keys=list(pred.state_dict()))
    pred.pipeline(ctx)
    state = P.local_model_state(ctx, weights)
    missing = pred.load_state_dict(state, strict=False).missing_keys
    if any(P.layer_of(k) is not None for k in missing):
        raise ValueError(f"the stack's weights lack {missing}")
    pred.train()
    x = torch.from_numpy(np.random.default_rng(job["seed"]).standard_normal(
        (job["batch"], job["tokens"], C)).astype(np.float32)).to(device)
    x.requires_grad_()
    mask = L.neg_inf_causal_mask(job["tokens"], device=x.device)
    out = pred._train_layers(x, mask, "kernel", None)
    (out ** 2).sum().backward()
    return {"out": out.detach().cpu(), "dx": x.grad.cpu(),
            "grads": {n: p.grad.cpu() for n, p in pred.named_parameters()
                      if P.layer_of(n) is not None},
            "stage": ctx.stage, "launches": launch_counts()}


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


JOBS = {"train": run_train, "eval": run_eval, "meters": run_meters,
        "stack": run_stack}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    with open(argv[0]) as f:
        spec = json.load(f)
    resolve_device(spec["device"])
    info = mesh.init_distributed(spec["device"])
    os.makedirs(spec["out"], exist_ok=True)
    try:
        for job in spec["jobs"]:
            record = {**JOBS[job["kind"]](job, info["device"]),
                      "backend": info["backend"]}
            torch.save(record, os.path.join(
                spec["out"], f"{job['name']}.rank{info['rank']}.pt"))
    finally:
        mesh.shutdown()


if __name__ == "__main__":
    main()
