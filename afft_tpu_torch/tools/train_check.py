"""Flagship-scale training check on the card.

The port's counterpart of the repo's ``tools/tpu_train_check.py``: a few
hundred real training steps of the flagship (the 4-modal SA-Fuser over a
6-layer GPT-2 predictor, ~388 M parameters; bf16 compute; mixup, the future
and past cross-entropies and the past-feature regression) through
``Runner.train_step`` and the training kernels, on a pool of fixed
synthetic EK100-shaped batches, timed with CUDA events after the first
step; the loss must fall. Writes one JSON record (the JAX tool's keys;
``compile_s`` is the first step's seconds, the kernels' build included
where they are not built yet) and prints it.

    python -m afft_tpu_torch.tools.train_check [--steps 200] [--batch 64]
        [--distinct-batches 8] [--master-dtype float32|bfloat16]
        [--grad-accum M] [--seed 0] [--out FILE] [--against FILE]
        [--device cuda|cpu]

``--master-dtype bfloat16`` keeps bf16 master weights and bf16 optimizer
state, the updates written back with stochastic rounding
(``train.optim.stochastic_round_bf16``). ``--grad-accum M`` splits each
batch into M microbatches (``train.grad_accum``). ``--against FILE`` reads
an earlier run's record (the same seed, steps and batches) and adds
``trace_delta``: the differences between the two loss traces
(``loss_every_50``, this run's minus the earlier one's: their mean, mean
|Δ| and max |Δ|) and each trace's mean and standard deviation over its last
fifth (the last 1,000 of 5,000 steps). On the card unless ``--device cpu``.

``run`` is the body, over config overrides on top of the flagship's, so
that a test can run it narrow and shallow.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# the flagship of tools/tpu_train_check.py: EK100's four modalities
# (rgb / objects / audio / flow features), the fuser at C 1024, six fuser
# blocks and six GPT-2 layers, SGD with Nesterov momentum
FLAGSHIP = ("model.modal_dims={rgb:1024, objects:352, audio:1024, flow:1024}",
            "model.common_dim=1024", "model.fuser.depth=6",
            "model.common.fp_layers=6", "opt.optimizer.nesterov=true")
N_CLASSES = 3806
FRAMES = 16
LR = 1e-3
LOSS_WTS = {"cls_action": 1.0, "past_cls_action": 1.0, "past_reg": 1.0}
MIXUP_ALPHA = 0.1
LABEL_SMOOTHING = {"action": 0.4}
MOMENTUM = 0.9
TRACE_EVERY = 50


def flagship_config(overrides=()):
    """The flagship's composed config with ``overrides`` applied after its
    lines."""
    from ..config import CONF_DIR, compose
    return compose(CONF_DIR, list(FLAGSHIP) + list(overrides))


def build_runner(cfg, n_classes=N_CLASSES, *, master_dtype="float32",
                 compute_dtype="bfloat16", grad_accum=1, seed=0,
                 device="cuda", weights=None):
    """The runner of tools/tpu_train_check.py:61-85 on the port: the model
    drawn from ``seed`` (or ``weights``, a state dict), one parameter group
    at the config's lr and weight decay, SGD with Nesterov momentum (bf16
    state with bf16 masters), mixup with label smoothing on ``action`` and
    on the backbone's features, no gradient clipping."""
    from .. import resolve_device
    from ..models import BaseModel
    from ..train import optim as O
    from ..train.mixup import MixUp
    from ..train.runner import DTYPES, Runner

    device = resolve_device(device)
    num_classes = {"action": int(n_classes)}
    with torch.device(device):
        model = BaseModel(cfg.model, num_classes=num_classes)
    if weights is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        model.reset_parameters(gen)
    else:
        model.load_state_dict(weights, strict=True)
    low = master_dtype == "bfloat16"
    groups = O.build_groups(list(model.named_parameters()), None,
                            cfg.opt.lr, cfg.opt.wd)
    optimizer = O.sgd(momentum=MOMENTUM, nesterov=True,
                      state_dtype="bfloat16" if low else None)
    mixup = MixUp(alpha=MIXUP_ALPHA, label_smoothing=dict(LABEL_SMOOTHING),
                  num_classes=num_classes)
    return Runner(model, optimizer, groups, loss_wts=LOSS_WTS, mixup=mixup,
                  mixup_backbone=True, compute_dtype=DTYPES[compute_dtype],
                  master_dtype=DTYPES[master_dtype],
                  grad_accum=int(grad_accum), seed=int(seed))


def make_batches(cfg, batch, n, n_classes=N_CLASSES, frames=FRAMES, seed=0):
    """``n`` fixed synthetic batches of ``batch`` clips from a numpy
    generator, drawn in tools/tpu_train_check.py:87-100's order: N(0, 1)
    features of each modality over ``frames`` frames, the future action,
    the per-frame past actions, every row valid."""
    rng = np.random.default_rng(seed)
    dims = cfg.model.modal_dims.to_container()
    out = []
    for _ in range(n):
        out.append({
            "data_dict": {m: rng.standard_normal((batch, frames, int(d)))
                          .astype(np.float32) for m, d in dims.items()},
            "target": {"action": rng.integers(0, n_classes, (batch,))},
            "target_subclips": {"action": rng.integers(
                0, n_classes, (batch, frames, 1))},
            "valid": np.ones((batch,), bool)})
    return out


def on_device(batch, device):
    """A numpy batch's arrays as tensors on ``device`` (the pool lives on
    the card, as the JAX tool's does)."""
    if isinstance(batch, dict):
        return {k: on_device(v, device) for k, v in batch.items()}
    return torch.as_tensor(batch).to(device)


def device_name(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    ``"cpu"``."""
    if torch.device(device).type != "cuda":
        return "cpu"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        smi = []
    index = torch.device(device).index or 0
    return smi[index] if len(smi) > index \
        else torch.cuda.get_device_name(index)


class _Clock:
    """CUDA events on the card, the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def mark(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def ms(self, start, end):
        if self.cuda:
            end.synchronize()
            return start.elapsed_time(end)
        return (end - start) * 1e3


def run(overrides=(), *, steps=200, batch=64, distinct_batches=8,
        master_dtype="float32", grad_accum=1, seed=0, device="cuda",
        compute_dtype="bfloat16", n_classes=N_CLASSES, frames=FRAMES,
        weights=None, mixup_lam=None, keep_runner=False):
    """``steps`` training steps of the flagship (with ``overrides``) on
    ``distinct_batches`` batches taken in turn; returns the record (and the
    runner with ``keep_runner``). ``weights`` (a state dict) replaces the
    seeded draw and ``mixup_lam`` pins mixup's λ, so that a step can be
    held against another implementation's."""
    from ..ops import launch_counts, reset_launches

    if steps < 1:
        raise ValueError("at least one step")
    cfg = flagship_config(overrides)
    runner = build_runner(cfg, n_classes, master_dtype=master_dtype,
                          compute_dtype=compute_dtype, grad_accum=grad_accum,
                          seed=seed, device=device, weights=weights)
    n_params = sum(p.numel() for p in runner.model.parameters())
    pool = [on_device(b, runner.device) for b in
            make_batches(cfg, batch, distinct_batches, n_classes, frames,
                         seed)]
    if mixup_lam is not None:
        pool = [{**b, "mixup_lam": mixup_lam} for b in pool]
    clock = _Clock(runner.device)

    def step(i):
        return runner.train_step(pool[i % len(pool)], LR, LR)[0]

    # the first step (the loss before any update, on batch 0) builds the
    # kernels where they are not built yet: timed apart
    reset_launches()
    t0 = time.perf_counter()
    first = step(0)
    first = {k: float(v) for k, v in first.items()}
    first_s = time.perf_counter() - t0
    losses = [first["total_loss"]]
    t0, start = time.perf_counter(), clock.mark()
    for i in range(1, steps):
        losses.append(step(i)["total_loss"])
    end = clock.mark()
    host_s = time.perf_counter() - t0  # the enqueue, before any wait
    window_ms = clock.ms(start, end) if steps > 1 else None
    trace = [float(losses[i]) for i in range(1, steps)
             if (i + 1) % TRACE_EVERY == 0]
    loss_last = float(losses[-1])
    ms = window_ms / (steps - 1) if steps > 1 else None
    result = {
        "what": "flagship training check on the port (synthetic "
                "EK100-shaped batches, the whole mixed-precision "
                "Runner.train_step through the training kernels)",
        "model_params": n_params,
        "batch": batch,
        "steps": steps,
        "distinct_batches": distinct_batches,
        "seed": seed,
        "ms_per_step": ms,
        "clips_per_sec": batch / ms * 1e3 if ms else None,
        "host_ms_per_step": host_s / (steps - 1) * 1e3 if steps > 1
        else None,
        "compile_s": first_s,
        "loss_first": first["total_loss"],
        "first_step_losses": first,
        "loss_last": loss_last,
        "loss_every_50": trace,
        "loss_decreased": loss_last < first["total_loss"],
        "master_dtype": master_dtype,
        "grad_accum": grad_accum,
        "launches": {k: n for k, n in launch_counts().items() if n},
        "device": device_name(runner.device),
    }
    return (result, runner) if keep_runner else result


def _label(record) -> str:
    return "bf16m" if record["master_dtype"] == "bfloat16" else "fp32"


def trace_delta(this, against):
    """TRAIN_LONG_r05.json's ``trace_delta`` of two records' loss traces
    (``loss_every_50``, taken at the same steps): Δ = this run's minus the
    earlier one's, its mean (signed, as the JAX artifact records it), mean
    |Δ| and max |Δ|; each trace's mean and standard deviation over its last
    fifth, keyed by its master dtype (``fp32`` / ``bf16m``; ``against`` /
    ``this`` when both runs have the same)."""
    a = np.asarray(against["loss_every_50"], np.float64)
    b = np.asarray(this["loss_every_50"], np.float64)
    if len(a) != len(b) or not len(a):
        raise ValueError(f"loss traces of {len(b)} and {len(a)} entries: "
                         "compare runs of the same steps")
    late = max(1, len(a) // 5)
    names = (_label(against), _label(this))
    if names[0] == names[1]:
        names = ("against", "this")
    delta = b - a
    out = {"mean": float(delta.mean()),
           "mean_abs": float(np.abs(delta).mean()),
           "max_abs": float(np.abs(delta).max()),
           "late_window_entries": late}
    for name, trace in zip(names, (a, b)):
        out[f"late_window_mean_{name}"] = float(trace[-late:].mean())
        out[f"late_window_std_{name}"] = float(trace[-late:].std())
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--distinct-batches", type=int, default=8)
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="M > 1: M microbatches a step (train.grad_accum)")
    ap.add_argument("--master-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="bfloat16: bf16 master weights and optimizer state, "
                         "stochastically rounded updates "
                         "(train.master_dtype)")
    ap.add_argument("--seed", type=int, default=0,
                    help="the weights, the batches and the runner's "
                         "generators")
    ap.add_argument("--out", default="train_check.json",
                    help="the JSON record's path")
    ap.add_argument("--against", default=None,
                    help="an earlier run's record: add trace_delta")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:K or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from .. import resolve_device
    resolve_device(args.device)
    against = None
    if args.against:
        with open(args.against) as f:
            against = json.load(f)
    result = run(steps=args.steps, batch=args.batch,
                 distinct_batches=args.distinct_batches,
                 master_dtype=args.master_dtype, grad_accum=args.grad_accum,
                 seed=args.seed, device=args.device)
    if against is not None:
        result["against"] = {"file": args.against,
                             "master_dtype": against["master_dtype"]}
        result["trace_delta"] = trace_delta(result, against)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    # the record is kept either way; a loss that did not fall fails the run
    if not result["loss_decreased"]:
        sys.exit(f"loss did not decrease: {result['loss_first']} -> "
                 f"{result['loss_last']}")
    return result


if __name__ == "__main__":
    main()
