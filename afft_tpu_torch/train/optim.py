"""Optimizers and LR schedules with the reference's semantics.

Port of afft_tpu/train/optim.py (reference torch.optim.{SGD, Adam, AdamW} as
configured by the opt config groups, and common/scheduler.py: CosineLR with
eta_min scaled by the world size, the per-iteration Warmup wrapper,
WarmupMultiStepLR, ReduceLROnPlateau).

Parameter groups replicate reference train.py:189-225 (``prepare_params``):
a list of (module-name prefix, lr, wd) rules over the model's parameter
names; lr == 0 freezes a parameter (it is left out of the update
altogether). ``torch.optim`` carries the update: its SGD (buffer = first
gradient on a parameter's first step, coupled weight decay, Nesterov), Adam
(coupled) and AdamW (decoupled) are the reference's own. The schedules are
host functions of the iteration; ``Optimizer.step`` scales every group's base
lr by lr / base_lr before it steps, as a torch scheduler rewrites
``param_group["lr"]``.

Waiting (ROADMAP.md §A.7): the ``state_dtype`` option (optimizer state in
bf16) and stochastic rounding for bf16 master weights.
"""

from __future__ import annotations

import math
from bisect import bisect_right
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch


# ---------------------------------------------------------------------------
# parameter groups
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GroupSpec:
    lr: float
    wd: float
    frozen: bool


def build_groups(named_params, lr_wd: Optional[List], overall_lr: float,
                 overall_wd: float) -> Dict[str, GroupSpec]:
    """{parameter name: GroupSpec} from (prefix, lr, wd) rules (reference
    train.py:189-225). Prefixes match the '.'-joined parameter names, with
    or without a leading ``model.``; ``__all__`` matches everything."""
    rules = []
    for names, lr, wd in (lr_wd or []):
        if not isinstance(names, (list, tuple)):
            names = [names]
        rules += [(str(n), float(lr), float(wd)) for n in names]

    def spec_for(name):
        for prefix, lr, wd in rules:
            if prefix == "__all__" or name.startswith(prefix) \
                    or name.startswith(prefix.replace("model.", "")):
                return GroupSpec(lr, wd, lr == 0.0)
        return GroupSpec(overall_lr, overall_wd, overall_lr == 0.0)

    return {name: spec_for(name) for name, _ in named_params}


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

class Optimizer:
    """A ``torch.optim`` optimizer over per-parameter GroupSpecs.

    ``bind(named_params, groups)`` builds one torch parameter group for
    each distinct (lr, wd) and leaves frozen parameters out;
    ``step(lr_factor)`` scales every group's base lr and steps on the
    parameters' ``.grad``."""

    def __init__(self, factory: Callable, state_dtype=None, **kwargs):
        if state_dtype is not None:
            raise NotImplementedError(
                "opt.optimizer.state_dtype is not ported (ROADMAP.md §A.7)")
        self._factory, self._kwargs = factory, kwargs
        self.opt = None

    def bind(self, named_params, groups: Dict[str, GroupSpec]):
        by_spec: Dict[GroupSpec, list] = {}
        for name, p in named_params:
            spec = groups[name]
            if not spec.frozen:
                by_spec.setdefault(spec, []).append(p)
        param_groups = [{"params": ps, "lr": spec.lr, "base_lr": spec.lr,
                         "weight_decay": spec.wd}
                        for spec, ps in by_spec.items()]
        self.opt = self._factory(param_groups, **self._kwargs)
        return self

    def step(self, lr_factor: float):
        for group in self.opt.param_groups:
            group["lr"] = group["base_lr"] * lr_factor
        self.opt.step()


def sgd(momentum=0.9, nesterov=False, state_dtype=None, **_ignored):
    """torch.optim.SGD: grad += wd * p; buf = grad on the first step, then
    mu * buf + grad; d = grad + mu * buf (Nesterov) or buf; p -= lr * d."""
    return Optimizer(torch.optim.SGD, state_dtype, momentum=momentum,
                     nesterov=nesterov)


def adam(betas=(0.9, 0.999), eps=1e-8, state_dtype=None, **_ignored):
    """torch.optim.Adam (weight decay coupled into the gradient)."""
    return Optimizer(torch.optim.Adam, state_dtype, betas=tuple(betas),
                     eps=eps)


def adamw(betas=(0.9, 0.999), eps=1e-8, state_dtype=None, **_ignored):
    """torch.optim.AdamW (weight decay decoupled)."""
    return Optimizer(torch.optim.AdamW, state_dtype, betas=tuple(betas),
                     eps=eps)


# ---------------------------------------------------------------------------
# schedules (host-side pure functions of the iteration)
# ---------------------------------------------------------------------------

def cosine_schedule(num_epochs, iters_per_epoch, world_size=1, eta_min=1e-6,
                    **_ignored) -> Callable[[int, float], float]:
    """CosineAnnealingLR with eta_min scaled by the world size and zero lr
    past T_max (reference common/scheduler.py:57-75)."""
    T_max = num_epochs * iters_per_epoch
    eta = float(eta_min) * world_size

    def lr_at(k: int, base_lr: float) -> float:
        if k >= T_max:
            return 0.0
        return eta + (base_lr - eta) * (1 + math.cos(math.pi * k / T_max)) / 2

    # torch's CosineAnnealingLR steps with a chained recursive formula, so
    # when the Warmup wrapper hands over, the cosine continues from the last
    # warmup lr rather than snapping back to base (the reference's
    # behaviour, kept as it is)
    lr_at.anchor_at_warmup_end = True
    return lr_at


def multistep_schedule(milestone_epochs=None, gamma=0.1, warmup_factor=1.0 / 3,
                       warmup_epochs=5, warmup_method="linear",
                       iters_per_epoch=None, world_size=None,
                       milestones=None, **_ignored):
    """WarmupMultiStepLR (reference common/scheduler.py:9-54);
    ``milestones`` is accepted as a torch-style alias."""
    if milestone_epochs is None:
        milestone_epochs = milestones
    if milestone_epochs is None:
        raise ValueError(
            "opt/scheduler=multi_step needs milestone epochs, e.g. "
            "opt.scheduler.milestone_epochs=[30,40]")
    milestones = [iters_per_epoch * m for m in milestone_epochs]
    warmup_iters = max(warmup_epochs * iters_per_epoch, 1)

    def lr_at(k: int, base_lr: float) -> float:
        factor = 1.0
        if k < warmup_iters:
            if warmup_method == "constant":
                factor = warmup_factor
            else:
                alpha = k / warmup_iters
                factor = warmup_factor * (1 - alpha) + alpha
        return base_lr * factor * gamma ** bisect_right(milestones, k)

    return lr_at


class PlateauSchedule:
    """torch.optim.lr_scheduler.ReduceLROnPlateau semantics as an
    (iteration, base_lr) -> lr callable with an ``observe(metric)`` hook
    that the training loop calls once per epoch."""

    def __init__(self, mode="min", factor=0.1, patience=10, threshold=1e-4,
                 threshold_mode="rel", cooldown=0, min_lr=0.0, eps=1e-8,
                 **_ignored):
        if mode not in ("min", "max") or threshold_mode not in ("rel", "abs"):
            raise ValueError(f"mode {mode!r} / threshold_mode "
                             f"{threshold_mode!r} not supported")
        if not factor < 1.0:
            raise ValueError("factor should be < 1.0")
        self.mode, self.factor, self.patience = mode, factor, patience
        self.threshold, self.threshold_mode = threshold, threshold_mode
        self.cooldown, self.min_lr, self.eps = cooldown, min_lr, eps
        self.scale = 1.0
        self.best = math.inf if mode == "min" else -math.inf
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    def _is_better(self, a):
        t = self.threshold
        if self.mode == "min":
            return a < self.best * (1.0 - t) if self.threshold_mode == "rel" \
                else a < self.best - t
        return a > self.best * (1.0 + t) if self.threshold_mode == "rel" \
            else a > self.best + t

    def observe(self, metric: float):
        """Epoch-end update: torch's ReduceLROnPlateau.step(metric)."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            self.scale *= self.factor
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0

    def __call__(self, k: int, base_lr: float) -> float:
        return max(base_lr * self.scale, self.min_lr)

    def state_dict(self):
        return {k: getattr(self, k) for k in
                ("scale", "best", "num_bad_epochs", "cooldown_counter")}

    def load_state_dict(self, d):
        for k, v in d.items():
            setattr(self, k, v)


def plateau_schedule(mode="min", factor=0.1, patience=10, threshold=1e-4,
                     threshold_mode="rel", cooldown=0, min_lr=0.0, eps=1e-8,
                     iters_per_epoch=None, world_size=None, **_ignored):
    """ReduceLROnPlateau factory (reference common/scheduler.py:78-85)."""
    return PlateauSchedule(mode=mode, factor=factor, patience=patience,
                           threshold=threshold, threshold_mode=threshold_mode,
                           cooldown=cooldown, min_lr=min_lr, eps=eps)


def warmup_wrap(base_schedule, init_lr_ratio=0.0, num_epochs=5,
                iters_per_epoch=None, world_size=None, **_ignored):
    """Per-iteration linear warmup, then the base schedule (reference
    common/scheduler.py:88-136). The base schedule's counter starts at 1 on
    the first iteration after the warmup, as the torch wrapper counts."""
    warmup_iters = max(num_epochs * iters_per_epoch, 1)
    ratio = init_lr_ratio if warmup_iters > 1 else 1.0
    anchor = getattr(base_schedule, "anchor_at_warmup_end", False)

    def lr_at(t: int, base_lr: float) -> float:
        if t < warmup_iters:
            return base_lr * (ratio + (1 - ratio) * (t / warmup_iters))
        if anchor:
            base_lr = base_lr * (ratio + (1 - ratio) *
                                 ((warmup_iters - 1) / warmup_iters))
        return base_schedule(t - warmup_iters + 1, base_lr)

    if hasattr(base_schedule, "observe"):
        lr_at.observe = base_schedule.observe
        lr_at.state_dict = base_schedule.state_dict
        lr_at.load_state_dict = base_schedule.load_state_dict
    return lr_at


def build_schedule(opt_cfg, iters_per_epoch: int, world_size: int = 1):
    """The configured scheduler inside the configured warmup
    (afft_tpu/train/loop.py:130-136)."""
    from ..config.registry import instantiate
    main = instantiate(opt_cfg.scheduler, iters_per_epoch=iters_per_epoch,
                       world_size=world_size)
    return instantiate(opt_cfg.warmup, main, iters_per_epoch=iters_per_epoch,
                       world_size=world_size)
