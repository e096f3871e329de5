"""Training entry: dataset / model / optimizer assembly and the epoch loop.

Port of afft_tpu/train/loop.py (reference train.py: main :293-425,
run_one_epoch :228-290, get_dataloader :106-153, create_ckpt_path
:170-186). One process a device: the card unless the caller asks for the
CPU. Under torchrun (or a multi-task SLURM step) the processes train data
parallel (``parallel.mesh``; ``Runner`` takes the global batch's step):
each loads its shard of the train and validation sets (the strided,
wrap-padded shards of ``data.loader.shard_indices``), the schedule counts
the process count as ``world_size``, preemption is decided across all ranks
at an epoch's end, validation meters are summed over the ranks, only rank 0
writes checkpoints and ``metrics.jsonl``, and all ranks leave each epoch
together.

- Each iteration is ``Runner.train_step`` at the per-iteration schedule's
  lr; losses are read back only at the logging cadence (``LOG_EVERY``,
  with the NaN check), metrics accumulate on the device and are read once
  an epoch (``Runner.absorb_accum``).
- Validation runs every epoch; ``checkpoint_best`` follows
  ``primary_metric``, ``checkpoint_last`` is written every
  ``train.save_last_every`` epochs and at the end, ``checkpoint_epochN``
  every ``train.checkpoint_every``. ``train.resume=true`` continues from
  ``checkpoint_last`` (weights, optimizer, schedule state and the training
  randomness); SIGTERM checkpoints and exits at the next safe point. A
  checkpoint is resumed whatever the options it was written under: weights
  and optimizer state are cast to the run's master and state dtypes (bf16
  masters from fp32 ones and back, afft_tpu/train/loop.py:401-412), and
  ZeRO-1 checkpoints hold whole tensors.
- ``data_on_device=true`` serves batches from a device-resident feature
  cache (``data.device_cache``) or raises; it never falls back to the host
  loader.
- Each epoch logs, beside its metrics, ``ms_per_iter`` (median of the
  intervals between CUDA events recorded at each iteration's start, so
  device-paced; host clock on the CPU), ``host_ms_per_iter`` (median host
  time of a step's call), ``window_ms`` (the epoch from its first
  iteration's start to its last step's end, stalls included) and
  ``clips_per_s`` (the epoch's valid clips over ``window_ms``), rank 0's
  in a data-parallel run.
- ``train.pipeline_stages`` = S > 1 (GPipe, ``parallel.pipeline``): the
  processes form D = R / S data replicas of S stages. The loaders shard by
  the data replica over D, so the stages of one replica see the same
  batches, the schedule counts D as ``world_size``, and checkpoints are
  written in the unpipelined layout and resumed into either layout
  (``Runner.checkpoint_state`` / ``load_checkpoint_state``).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import statistics
import threading
import time
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..data.dataset import ConcatClipDataset, ZeroMaskFeats
from ..data.loader import BatchLoader, get_dataset
from ..ops import launch_counts, reset_launches
from ..parallel import mesh
from ..utils.logging import ExperimentLogger, ProfilerHook, human_format
from .checkpoint import (CKPT_BEST_DIRNAME, CKPT_LAST_DIRNAME,
                         init_from_model, load_checkpoint, save_checkpoint,
                         wait_for_pending_saves)
from .metrics import MetricTracker
from .runner import Runner, check_train_keys, pipeline_stages

DATASET_TRAIN_CFG_KEY = "dataset_train"
DATASET_EVAL_CFG_KEY = "dataset_eval"
LOG_EVERY = 200

log = logging.getLogger(__name__)


def get_transforms(cfg, train: bool):
    """ZeroMask augmentation on train features; identity on eval
    (reference train.py:32-52)."""
    mods = list(cfg.model.modal_dims.keys())
    if train and cfg.data_train.zero_mask_rate > 0:
        return {m: ZeroMaskFeats(cfg.data_train.zero_mask_rate) for m in mods}
    return {m: None for m in mods}


def create_ckpt_path(cfg, interactive=True):
    """Reference train.py:170-186 naming scheme. A finished experiment is
    not run again unless ``train.resume=true`` or ``+overwrite=true`` (every
    rank decides on what it sees before rank 0 removes anything; only a
    one-process run asks)."""
    rank, world = mesh.rank_and_world()
    expt_name = cfg.get("experiment_name")
    fusion_method = cfg.model.fuser._target_.split(".")[-1]
    fp_method = cfg.model.CMFP._target_.split(".")[-1]
    modalities = "_".join(cfg.model.modal_dims.keys())
    experiment_name = f"{fp_method}_{fusion_method}_{modalities}"
    if expt_name is not None:
        experiment_name += f"_{expt_name}"
    ckpt_path = os.path.join(cfg.cwd, "checkpoints", experiment_name)
    os.makedirs(ckpt_path, exist_ok=True)
    best = os.path.join(ckpt_path, CKPT_BEST_DIRNAME)
    if os.path.exists(best) and not cfg.train.get("resume", False):
        # reference train.py:179-185 asks; non-interactive runs must opt in
        # via +overwrite=true
        confirmed = bool(cfg.get("overwrite", False))
        if not confirmed and interactive and world == 1 and os.isatty(0):
            ans = input("This experiment already exists. Override? (y/N) ")
            confirmed = ans.strip().lower() in ("y", "yes")
        if not confirmed:
            raise ValueError(
                "This experiment is already done. Rename it, set "
                "train.resume=true, or pass +overwrite=true.")
        mesh.barrier()
        if rank == 0:
            if os.path.isdir(best):
                shutil.rmtree(best)
            else:
                os.remove(best)
    mesh.barrier()
    return experiment_name, ckpt_path


def build_dataloaders(cfg, pin_memory: bool = False, shard_id: int = 0,
                      num_shards: int = 1):
    """(train set, its loader, val set, its loader): this rank's shards of
    both, ``train.batch_size`` clips a batch on each rank."""
    transforms_train = get_transforms(cfg, train=True)
    transforms_val = get_transforms(cfg, train=False)
    datasets_train = [
        get_dataset(cfg[el], cfg.data_train, transforms_train, log)
        for el in cfg.keys() if el.startswith(DATASET_TRAIN_CFG_KEY)
    ]
    dataset_train = ConcatClipDataset(datasets_train) \
        if len(datasets_train) > 1 else datasets_train[0]
    dataset_val = get_dataset(cfg[DATASET_EVAL_CFG_KEY], cfg.data_eval,
                              transforms_val, log)

    batch = int(cfg.train.batch_size)
    eval_batch = int(cfg.eval.batch_size or batch * 4)
    sample_weights = None
    cb_alpha = float(cfg.train.get("class_balanced_alpha") or 0.0)
    if cb_alpha > 0.0:
        from ..data.stats import balanced_sample_weights, summarize
        target = dataset_train.label_type[0] \
            if hasattr(dataset_train, "label_type") \
            else next(iter(dataset_train.classes))
        sample_weights = balanced_sample_weights(dataset_train, target,
                                                 cb_alpha)
        log.info("class-balanced resampling on %r (alpha=%.2f); "
                 "long-tail stats: %s", target, cb_alpha,
                 summarize(dataset_train).get(target))
    loader_train = BatchLoader(
        dataset_train, batch_size=batch, shuffle=True, seed=cfg.seed,
        num_workers=cfg.workers, sample_weights=sample_weights,
        pin_memory=pin_memory, shard_id=shard_id, num_shards=num_shards)
    loader_val = BatchLoader(
        dataset_val, batch_size=eval_batch, shuffle=False, seed=cfg.seed,
        num_workers=cfg.workers, pin_memory=pin_memory, shard_id=shard_id,
        num_shards=num_shards)
    log.info("train %d clips / val %d clips; global batch %d over %d "
             "processes", len(dataset_train), len(dataset_val),
             batch * num_shards, num_shards)
    return dataset_train, loader_train, dataset_val, loader_val


def class_weights_for(cfg, dataset_train, num_classes):
    """Effective-number class weights of the train split for
    ``train.class_weight_beta`` (afft_tpu/train/loop.py:350-362), or None."""
    beta = cfg.train.get("class_weight_beta")
    if beta is None:
        return None
    from ..data.stats import class_counts, effective_number_class_weights
    sub_dfs = [d.df for d in dataset_train.datasets] \
        if hasattr(dataset_train, "datasets") else [dataset_train.df]
    weights = {t: effective_number_class_weights(
                   class_counts(dataset_train, t), float(beta))
               for t in num_classes
               if all(f"{t}_class" in df for df in sub_dfs)}
    log.info("effective-number class weighting (beta=%s) on %s", beta,
             sorted(weights))
    return weights


def _install_preemption_handler() -> Optional[threading.Event]:
    """Graceful preemption: SIGTERM sets the returned Event; the loop
    checkpoints and exits at the next safe point instead of losing the
    epoch. None when handlers can't be installed (not the main thread)."""
    import signal
    ev = threading.Event()

    def handler(signum, frame):
        ev.set()
        log.warning("SIGTERM: checkpointing and exiting at the next "
                    "safe point")

    try:
        signal.signal(signal.SIGTERM, handler)
    except ValueError:
        return None
    return ev


def run_one_epoch(runner, loader, metric_tracker, *, is_training,
                  lr_schedule=None, base_lr=None, step_counter=0,
                  profiler=None, preempt=None):
    """One pass over ``loader``: train steps or eval steps. Returns
    (step counter, timing dict of the pass)."""
    cuda = runner.device.type == "cuda"
    accum = runner.new_accum()
    events, host_ms, clips, t_first = [], [], 0, None
    t_dl = time.perf_counter()
    for idx, batch in enumerate(loader):
        if preempt is not None and preempt.is_set():
            # abandon the epoch mid-stream: its metrics are partial, and
            # the loop saves a checkpoint that redoes it
            log.warning("preemption: stopping epoch at iter %d", idx)
            break
        dl_time = time.perf_counter() - t_dl
        if t_first is None:
            t_first = time.perf_counter()
        if cuda:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        t_fw = time.perf_counter()
        if is_training:
            lr = lr_schedule(step_counter, base_lr)
            check = idx % LOG_EVERY == 0
            losses, _ = runner.train_step(batch, lr, base_lr,
                                          check_nan=check, accum=accum)
            step_counter += 1
            if profiler is not None:
                profiler.step(step_counter)
        else:
            runner.eval_step(batch, accum=accum)
        step_time = time.perf_counter() - t_fw
        host_ms.append(step_time * 1e3)
        n_valid = int(np.asarray(batch["valid"]).sum())
        clips += n_valid
        metric_tracker.update(
            {"T DataLoader": dl_time, "T Step": step_time}, n_valid,
            is_training)
        if is_training and idx % LOG_EVERY == 0:
            log.info("iter %d: loss %.4f lr %.2e (T data %.3fs step %.3fs)",
                     idx, float(losses["total_loss"]), lr, dl_time,
                     step_time)
        t_dl = time.perf_counter()
    iters = len(host_ms)
    if cuda and events:
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        torch.cuda.synchronize(runner.device)
        iter_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        window_ms = events[0].elapsed_time(events[-1])
    else:
        iter_ms = host_ms
        window_ms = (time.perf_counter() - t_first) * 1e3 if iters else 0.0
    runner.absorb_accum(metric_tracker, accum, is_training)
    metric_tracker.synchronize_between_processes(is_training)
    timing = {}
    if iters:
        ms = statistics.median(iter_ms)
        timing = {"iters": iters, "ms_per_iter": ms,
                  "host_ms_per_iter": statistics.median(host_ms),
                  "window_ms": window_ms,
                  "clips_per_s": clips / window_ms * 1e3}
    return step_counter, timing


def main(cfg, device="cuda", interactive: bool = True):
    """Train ``cfg`` (a composed config) on ``device`` (``cuda``: each rank
    its ``LOCAL_RANK``'s card; ``cuda:K`` pins every rank to card K);
    returns the best value of ``cfg.primary_metric``."""
    resolve_device(device)
    dist_info = mesh.init_distributed(device, log)
    device = dist_info["device"]
    rank, world = dist_info["rank"], dist_info["world_size"]
    is_master = rank == 0
    preempt_ev = _install_preemption_handler()
    reset_launches()  # the run's own kernel launches, logged at the end
    # the data x pipe grid (every rank a data replica without pipelining)
    check_train_keys(cfg.train, cfg.model)
    stages = pipeline_stages(cfg.train)
    grid = mesh.grid(stages)
    replica, replicas = grid.data, grid.replicas
    experiment_name, ckpt_path = create_ckpt_path(cfg, interactive)
    np.random.seed(cfg.seed)

    dataset_train, loader_train, dataset_val, loader_val = \
        build_dataloaders(cfg, pin_memory=device.type == "cuda",
                          shard_id=replica, num_shards=replicas)
    num_classes = {k: len(v) for k, v in dataset_train.classes.items()}
    runner = Runner.from_config(
        cfg, num_classes, device=device, iters_per_epoch=len(loader_train),
        world_size=replicas, class_mappings=dataset_train.class_mappings,
        class_weights=class_weights_for(cfg, dataset_train, num_classes))
    lr_schedule, base_lr = runner.lr_schedule, runner.base_lr
    n_params = sum(p.numel() for p in runner.model.parameters())
    log.info("Model: %s with %s params on %s", experiment_name,
             human_format(n_params), device)
    log.info("training: grad_accum %d, %s masters, optimizer state in %s, "
             "%s", runner.grad_accum, runner.master_dtype,
             runner.optimizer.state_dtype or "the masters' dtype",
             f"ZeRO-1 over {replicas} processes" if runner.zero is not None
             else "the optimizer state on every process")
    if runner.pipeline is not None:
        log.info("pipeline parallelism: %d data replicas x %d stages, %d "
                 "microbatches; stage %d holds predictor layers %d-%d",
                 replicas, stages, runner.pipeline.microbatches,
                 runner.pipeline.stage, runner.pipeline.layers.start,
                 runner.pipeline.layers.stop - 1)

    profiler = ProfilerHook(cfg.get("profile_dir"),
                            int(cfg.get("profile_start_step", 10)),
                            int(cfg.get("profile_stop_step", 20)))
    exp_logger = ExperimentLogger(
        ckpt_path, cfg.get("project_name", "Anticipation"), experiment_name,
        use_wandb=bool(cfg.get("use_wandb", True)),
        config=cfg.to_container(resolve=True)) if is_master else None

    if cfg.get("init_from_model"):
        paths = cfg.init_from_model
        if not isinstance(paths, list):
            paths = [paths]
        paths = [os.path.join(cfg.cwd, "checkpoints", p) for p in paths]
        state, _ = init_from_model(runner.model.state_dict(), paths,
                                   cfg.train.modules_to_keep, log)
        runner.load_model_state(state)
    metric_tracker = MetricTracker(num_classes, grid.data_group)

    start_epoch, step_counter, best_metric = 0, 0, 0.0
    last_path = os.path.join(ckpt_path, CKPT_LAST_DIRNAME)
    if cfg.train.get("resume", False) and (
            os.path.exists(last_path)
            # crash between the swap renames: load_checkpoint recovers it
            or os.path.exists(last_path + ".old-tmp")):
        ckpt = load_checkpoint(last_path)
        runner.load_checkpoint_state(ckpt["model"], ckpt["optimizer"])
        start_epoch = int(ckpt["epoch"])
        step_counter = int(ckpt["step"])
        best_metric = float(ckpt["best_metric"])
        if ckpt.get("schedule") and hasattr(lr_schedule, "load_state_dict"):
            # metric-driven schedules keep their earlier lr reductions
            lr_schedule.load_state_dict(ckpt["schedule"])
        if "rng" in ckpt:
            runner.load_rng_state(ckpt["rng"])
        log.info("Resumed from %s at epoch %d", last_path, start_epoch)

    cache_train = cache_val = None
    if cfg.get("data_on_device"):
        from ..data.device_cache import DeviceFeatureCache
        dtype = "int8" if cfg.get("data_on_device_dtype") == "int8" \
            else torch.bfloat16
        cache_train = DeviceFeatureCache(dataset_train, device, dtype=dtype)
        cache_val = DeviceFeatureCache(dataset_val, device, dtype=dtype)
        log.info("serving features from %s memory (data_on_device): "
                 "%d + %d bytes", device, cache_train.nbytes,
                 cache_val.nbytes)

    def epoch_loaders(epoch):
        if cache_train is not None:
            return (cache_train.iter_batches(
                        loader_train.batch_size, shuffle=True, seed=cfg.seed,
                        epoch=epoch, shard_id=replica, num_shards=replicas,
                        sample_weights=loader_train.sample_weights),
                    cache_val.iter_batches(loader_val.batch_size,
                                           shuffle=False, shard_id=replica,
                                           num_shards=replicas))
        loader_train.set_epoch(epoch)
        return loader_train, loader_val

    train_iters = val_batches = 0
    for epoch in range(start_epoch, cfg.train.num_epochs):
        epoch_train_loader, epoch_val_loader = epoch_loaders(epoch)
        lr = lr_schedule(step_counter, base_lr)
        log.info("Epoch %d of %d with lr %g", epoch + 1,
                 cfg.train.num_epochs, lr)
        metric_tracker.reset()

        epoch_start_step = step_counter
        # several processes never stop mid-epoch (a rank leaving its
        # collectives would hang the others): they decide at its end
        step_counter, timing = run_one_epoch(
            runner, epoch_train_loader, metric_tracker, is_training=True,
            lr_schedule=lr_schedule, base_lr=base_lr,
            step_counter=step_counter, profiler=profiler,
            preempt=preempt_ev if world == 1 else None)
        _, val_timing = run_one_epoch(runner, epoch_val_loader,
                                      metric_tracker, is_training=False)
        train_iters += timing.get("iters", 0)
        val_batches += val_timing.get("iters", 0)
        # a preempted epoch's metrics are partial: it crowns no best
        # checkpoint, and resume redoes it
        interrupted = world == 1 and preempt_ev is not None \
            and preempt_ev.is_set()

        observe = getattr(lr_schedule, "observe", None)
        if observe is not None:
            plateau_metric = metric_tracker.get_data(cfg.primary_metric,
                                                     is_training=False)
            if plateau_metric is not None:
                observe(float(plateau_metric))

        sched_state = getattr(lr_schedule, "state_dict", lambda: None)()
        primary = metric_tracker.get_data(cfg.primary_metric,
                                          is_training=False)
        block = not cfg.train.get("async_checkpoint", True)
        is_best = not interrupted \
            and primary is not None and primary > best_metric
        last_every = int(cfg.train.get("save_last_every") or 1)
        is_last = not interrupted and ((epoch + 1) % last_every == 0
                                       or epoch + 1 == cfg.train.num_epochs)
        every = cfg.train.get("checkpoint_every")
        is_every = not interrupted \
            and bool(every) and (epoch + 1) % int(every) == 0
        if is_best:
            best_metric = primary

        def save(path, ck_epoch, ck_step, blocking):
            model_state, opt_state = runner.checkpoint_state()
            save_checkpoint(path, model_state, opt_state, ck_epoch,
                            ck_step, best_metric,
                            schedule_state=sched_state,
                            rng_state=runner.rng_state(), block=blocking)

        # the meters are summed over the ranks, so every rank takes these
        # decisions alike; save_checkpoint writes on rank 0 alone
        log.info(metric_tracker.to_string(is_training=True))
        log.info(metric_tracker.to_string(is_training=False))
        # one payload, written once: the epoch's other names link to it
        paths = [path for path, due in (
            (os.path.join(ckpt_path, CKPT_BEST_DIRNAME), is_best),
            (last_path, is_last),
            (os.path.join(ckpt_path, f"checkpoint_epoch{epoch + 1}"),
             is_every)) if due]
        if paths:
            save(paths, epoch + 1, step_counter, block)
        if not interrupted and exp_logger is not None:
            exp_logger.log({
                **metric_tracker.get_all_data(is_training=True),
                **metric_tracker.get_all_data(is_training=False),
                "lr": lr, **timing,
            }, step=epoch + 1)
        # one decision for every rank, which also leaves the epoch together
        if mesh.any_rank(preempt_ev is not None and preempt_ev.is_set()):
            # one final resume checkpoint, then a clean exit. A mid-epoch
            # interrupt records (epoch, epoch-start step) so resume redoes
            # the partial epoch; an epoch-boundary one whose checkpoint_last
            # was just written skips the duplicate write. The randomness
            # saved is the one after the partial epoch: the redone epoch
            # draws fresh masks.
            ck_epoch = epoch if interrupted else epoch + 1
            ck_step = epoch_start_step if interrupted else step_counter
            if interrupted or not is_last:
                save(last_path, ck_epoch, ck_step, True)
            log.warning("preemption: checkpoint saved at epoch %d; "
                        "exiting (resume with train.resume=true)", ck_epoch)
            break
    profiler.close()
    wait_for_pending_saves()
    run = {"device": str(device), "train_iters": train_iters,
           "val_batches": val_batches, "launches": launch_counts(),
           "world_size": world, "pipeline_stages": stages,
           "data_replicas": replicas}
    if cache_train is not None:
        run["device_cache_bytes"] = {"train": cache_train.nbytes,
                                     "val": cache_val.nbytes}
    if exp_logger is not None:
        exp_logger.summary(cfg.primary_metric, best_metric)
        exp_logger.summary("run", run)
    log.info("run: %s", json.dumps(run))
    log.info("Best %s: %s", cfg.primary_metric, best_metric)
    return best_metric
