"""Optimizers and LR schedules with the reference's semantics.

Port of afft_tpu/train/optim.py (reference torch.optim.{SGD, Adam, AdamW} as
configured by the opt config groups, and common/scheduler.py: CosineLR with
eta_min scaled by the world size, the per-iteration Warmup wrapper,
WarmupMultiStepLR, ReduceLROnPlateau).

Parameter groups replicate reference train.py:189-225 (``prepare_params``):
a list of (module-name prefix, lr, wd) rules over the model's parameter
names; lr == 0 freezes a parameter (it is left out of the update
altogether). The update is the port's own step with torch.optim's
semantics: SGD (buffer = first gradient on a parameter's first step,
coupled weight decay, Nesterov), Adam (coupled) and AdamW (decoupled), as
the reference runs them, over ``torch._foreach_*`` ops on each group's
tensors. Its own step, and not torch.optim, because torch.optim keeps the
state in the parameters' dtype: here the math runs in fp32 and the state is
stored in ``opt.optimizer.state_dtype`` when it is set, bf16 master weights
are written back with stochastic rounding (``stochastic_round_bf16``), and
ZeRO-1 runs the same step over one process's slice
(``parallel.sharding.Zero1``). Its state dict has torch.optim's layout, so
checkpoints of either load. The schedules are host functions of the
iteration; ``Optimizer.step`` scales every group's base lr by lr / base_lr
before it steps, as a torch scheduler rewrites ``param_group["lr"]``.
"""

from __future__ import annotations

import math
from bisect import bisect_right
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

from ..parallel import mesh


# ---------------------------------------------------------------------------
# parameter groups
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GroupSpec:
    lr: float
    wd: float
    frozen: bool


def build_groups(named_params, lr_wd: Optional[List], overall_lr: float,
                 overall_wd: float, stages: int = 1) -> Dict[str, GroupSpec]:
    """{parameter name: GroupSpec} from (prefix, lr, wd) rules (reference
    train.py:189-225). Prefixes match the '.'-joined parameter names, with
    or without a leading ``model.``; ``__all__`` matches everything. Under
    pipeline parallelism (``stages`` > 1, the whole model's parameters) a
    rule that gives a predictor's layers different groups raises, as the
    JAX loop refuses it (``parallel.pipeline.check_uniform_layer_groups``).
    """
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

    groups = {name: spec_for(name) for name, _ in named_params}
    if stages > 1:
        from ..parallel.pipeline import check_uniform_layer_groups
        check_uniform_layer_groups(groups)
    return groups


def group_layout(names, groups: Dict[str, GroupSpec]):
    """The optimizer's parameter groups over ``names``: [(GroupSpec, [names
    in order])], one for each distinct (lr, wd), in the order the specs
    first appear in ``groups``, frozen parameters left out. Over a pipeline
    stage's names (``groups`` of the whole model) the groups come in the
    canonical order, each with the stage's share of its parameters."""
    order: Dict[GroupSpec, int] = {}
    for spec in groups.values():
        order.setdefault(spec, len(order))
    by_spec: Dict[GroupSpec, list] = {}
    for n in names:
        spec = groups[n]
        if not spec.frozen:
            by_spec.setdefault(spec, []).append(n)
    return sorted(by_spec.items(), key=lambda item: order[item[0]])


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

STATE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def random_bits(shape, gen: torch.Generator) -> torch.Tensor:
    """16 random bits an element (int16), drawn from ``gen`` on its
    device."""
    return torch.randint(-(1 << 15), 1 << 15, tuple(shape),
                         dtype=torch.int16, generator=gen, device=gen.device)


def stochastic_round_bf16(x: torch.Tensor, bits: torch.Tensor):
    """Unbiased fp32 -> bf16 (afft_tpu/train/optim.py:202-217): the low 16
    bits of ``bits`` (an integer tensor of x's shape) are added to x's fp32
    bit pattern and the low half is cut off, so x rounds up with the
    probability of the fraction it drops; exactly representable values pass
    through unchanged. In int32 the addition wraps as the uint32 addition
    does, and the mask 0xFFFF0000 is -65536."""
    out = bits.to(torch.int32, copy=True)  # one temporary, worked in place
    out &= 0xFFFF
    out += x.to(torch.float32).contiguous().view(torch.int32)
    out &= -65536
    return out.view(torch.float32).to(torch.bfloat16)


def upcast(tensors):
    """fp32 copies of ``tensors``: (one flat buffer, views of it in their
    shapes). Two launches, not one a tensor: a pass over a model's ~400
    parameters is otherwise bound by the host's launches."""
    flat = torch.cat([t.reshape(-1) for t in tensors]).float()
    return flat, [v.view(t.shape) for v, t in
                  zip(flat.split([t.numel() for t in tensors]), tensors)]


def _store_flat(dsts, flat, gen: Optional[torch.Generator] = None):
    """``flat`` (fp32, the tensors of ``dsts`` laid end to end) into
    ``dsts`` (one dtype): bf16 rounded stochastically with bits drawn from
    ``gen`` when it is given, any other narrowing to nearest; one
    narrowing pass and one multi-tensor copy."""
    if gen is not None and dsts[0].dtype == torch.bfloat16:
        flat = stochastic_round_bf16(flat, random_bits(flat.shape, gen))
    else:
        flat = flat.to(dsts[0].dtype)
    torch._foreach_copy_(list(dsts), [v.view(d.shape) for v, d in zip(
        flat.split([d.numel() for d in dsts]), dsts)])


class Optimizer:
    """The optimizer step over per-parameter GroupSpecs: torch.optim's
    SGD, Adam and AdamW semantics, its state-dict layout, and the update
    math in fp32 whatever the dtypes of parameter, gradient and state
    (afft_tpu/train/optim.py:80-200).

    ``bind(named_params, groups)`` builds one parameter group for each
    distinct (lr, wd) and leaves frozen parameters out (``group_layout``); ``step(lr_factor,
    grads)`` scales every group's base lr and updates each parameter whose
    gradient (fp32, in ``grads``, aligned with ``params``) is not None, as
    torch.optim skips a parameter without ``.grad``. The state is stored in
    ``state_dtype`` when it is given, else in the parameter's dtype (as the
    JAX package's ``_state_zeros``). A bf16 parameter (the bf16 masters of
    ``train.master_dtype``) is updated in fp32 and written back rounded
    stochastically with the bits of the generator ``step`` is given.

    ZeRO-1 (``shard``): this process updates only its piece of each
    parameter (``parallel.sharding.Zero1``) and holds only those pieces'
    state; ``state_dict`` gathers the whole tensors, so a checkpoint is the
    same whether it was written sharded or not."""

    state_names = ()

    def __init__(self, state_dtype=None, **defaults):
        if isinstance(state_dtype, str):
            state_dtype = STATE_DTYPES[state_dtype]
        self.state_dtype = state_dtype
        self.defaults = defaults
        self.param_groups: List[dict] = []
        self.params: List[torch.Tensor] = []
        self.zero = None

    def bind(self, named_params, groups: Dict[str, GroupSpec]):
        named_params = list(named_params)
        params = dict(named_params)
        layout = group_layout([n for n, _ in named_params], groups)
        self.param_groups = [{"params": [params[n] for n in names],
                              "lr": spec.lr, "base_lr": spec.lr,
                              "weight_decay": spec.wd, **self.defaults}
                             for spec, names in layout]
        self.params = [p for g in self.param_groups for p in g["params"]]
        # the parameters' names, aligned with ``params``
        self.names = [n for _, names in layout for n in names]
        # per parameter: updates taken so far, and its state (of its piece
        # under ZeRO-1)
        self.steps = [0] * len(self.params)
        self.state: List[dict] = [{} for _ in self.params]
        return self

    def shard(self, zero, index):
        """Update only this process's pieces: ``zero`` is a
        ``parallel.sharding.Zero1`` over tensors of which ``params[i]`` is
        ``zero.params[index[i]]``. Any state held so far is cut to them."""
        self.zero, self._zindex = zero, list(index)
        self.state = [{k: self._piece(i, v) for k, v in st.items()}
                      for i, st in enumerate(self.state)]
        return self

    def _piece(self, i, full):
        return self.zero.piece(self._zindex[i], full)

    def views(self):
        """The tensors this process updates: each parameter, or its piece."""
        if self.zero is None:
            return self.params
        return [self.zero.piece_view(j) for j in self._zindex]

    def _state_dtype(self, p):
        return self.state_dtype or p.dtype

    @torch.no_grad()
    def step(self, lr_factor: float, grads=None,
             gen: Optional[torch.Generator] = None):
        """One update at every group's base lr times ``lr_factor``.
        ``grads``: fp32 gradients aligned with ``views()``, None where a
        parameter has none; by default the parameters' ``.grad``. The
        gradients are left as they are: weight decay and Nesterov's term
        are added out of place, as torch.optim adds them. A bf16
        parameter's write-back is afft_tpu/train/optim.py:220-240
        ``apply_updates``: p + u in fp32, rounded stochastically with bits
        from ``gen`` when it is given, else to nearest."""
        if grads is None:
            grads = [p.grad for p in self.params]
        views = self.views()
        start = 0
        for group in self.param_groups:
            group["lr"] = group["base_lr"] * lr_factor
            idx = [i for i in range(start, start + len(group["params"]))
                   if grads[i] is not None]
            start += len(group["params"])
            if not idx:
                continue
            for i in idx:
                self.steps[i] += 1
            # a bucket of parameters at a time: the fp32 working copies of
            # a narrower dtype, and Adam's, are one bucket's size
            done = 0
            for bucket in mesh.buckets([views[i] for i in idx],
                                       mesh.GRAD_BUCKET):
                part = idx[done:done + len(bucket)]
                done += len(bucket)
                flat, p32 = (None, bucket) \
                    if bucket[0].dtype == torch.float32 else upcast(bucket)
                self._update(group, p32, [grads[i] for i in part],
                             [self.state[i] for i in part],
                             [self.steps[i] for i in part],
                             [self._state_dtype(self.params[i])
                              for i in part])
                if flat is not None:
                    _store_flat(bucket, flat, gen)

    @staticmethod
    def _work(states, name, like, dtypes):
        """(fp32 working tensors of state ``name``, the flat buffer they
        view when they are copies of a narrower state, else None); the
        state is created as zeros (in its dtype) where it does not exist
        yet. An fp32 state is worked in place."""
        for st, g, dt in zip(states, like, dtypes):
            if name not in st:
                st[name] = torch.zeros_like(g, dtype=dt)
        stored = [st[name] for st in states]
        if stored[0].dtype == torch.float32:
            return stored, None
        flat, work = upcast(stored)
        return work, flat

    @staticmethod
    def _store(states, name, flat):
        """The working copies (``flat``) back into a narrower state."""
        if flat is not None:
            _store_flat([st[name] for st in states], flat)

    def _update(self, group, ps, gs, states, steps, dtypes):
        raise NotImplementedError

    # -- torch.optim's state-dict layout --------------------------------
    def state_dict(self) -> dict:
        """{"state": {index: {name: tensor}}, "param_groups": [...]} as
        torch.optim writes it, indices in the order of ``params``, the
        tensors whole (gathered from the processes under ZeRO-1: every
        process must call this together)."""
        names = [n for n in self.state_names if n != "step"]
        full = {n: [st.get(n) for st in self.state] for n in names}
        if self.zero is not None:
            for n, pieces in full.items():
                aligned = [None] * len(self.zero.params)
                for i, j in enumerate(self._zindex):
                    aligned[j] = pieces[i]
                whole = self.zero.gather(aligned)
                full[n] = [whole[j] for j in self._zindex]
        state = {}
        for i, steps in enumerate(self.steps):
            if not steps:
                continue
            entry = {}
            if "step" in self.state_names:
                entry["step"] = torch.tensor(float(steps))
            for n in names:
                if full[n][i] is not None:
                    entry[n] = full[n][i]
            state[i] = entry
        groups, start = [], 0
        for g in self.param_groups:
            n = len(g["params"])
            groups.append({**{k: v for k, v in g.items() if k != "params"},
                           "params": list(range(start, start + n))})
            start += n
        return {"state": state, "param_groups": groups}

    def load_state_dict(self, sd: dict) -> None:
        """The counterpart of ``state_dict``; also reads the state dicts of
        ``torch.optim.SGD`` / ``Adam`` / ``AdamW`` over the same groups
        (checkpoints written before the port had its own step). Each state
        tensor is cast to its state dtype and moved to its parameter's
        device; the groups' hyperparameters are restored as torch.optim
        restores them."""
        saved = sd["param_groups"]
        if [len(g["params"]) for g in saved] != \
                [len(g["params"]) for g in self.param_groups]:
            raise ValueError("the optimizer state does not match the "
                             "parameter groups")
        for g, s in zip(self.param_groups, saved):
            g.update({k: v for k, v in s.items() if k != "params"})
        by_index = {}  # saved index -> position in ``params``
        for s in saved:
            for k in s["params"]:
                by_index[k] = len(by_index)
        self.steps = [0] * len(self.params)
        self.state = [{} for _ in self.params]
        for key, entry in sd["state"].items():
            i = by_index[int(key)]
            p = self.params[i]
            for n, v in entry.items():
                if n == "step":
                    self.steps[i] = int(float(v))
                elif v is not None:
                    v = v.to(p.device, self._state_dtype(p),
                             copy=True).reshape(p.shape)
                    self.state[i][n] = v if self.zero is None \
                        else self._piece(i, v)
            if "step" not in entry:  # SGD's buffer: one step or more taken
                self.steps[i] = max(self.steps[i], 1)

    def state_bytes(self) -> int:
        """Bytes of optimizer state this process holds."""
        return sum(t.numel() * t.element_size() for st in self.state
                   for t in st.values())


class SGD(Optimizer):
    """torch.optim.SGD: g += wd * p; buf = g on a parameter's first step,
    then mu * buf + g; d = g + mu * buf (Nesterov) or buf; p -= lr * d."""

    state_names = ("momentum_buffer",)

    def __init__(self, momentum=0.0, nesterov=False, state_dtype=None):
        super().__init__(state_dtype, momentum=momentum, nesterov=nesterov,
                         dampening=0.0)

    def _update(self, group, ps, gs, states, steps, dtypes):
        mu, wd = group["momentum"], group["weight_decay"]
        if wd:
            gs = torch._foreach_add(gs, ps, alpha=wd)
        d = gs
        if mu:
            first = [k for k, st in enumerate(states)
                     if "momentum_buffer" not in st]
            later = sorted(set(range(len(states))) - set(first))
            bufs = [None] * len(states)
            for k in first:
                # torch starts the buffer at the gradient, not at zero
                bufs[k] = gs[k].clone()
                states[k]["momentum_buffer"] = bufs[k] \
                    if dtypes[k] == torch.float32 else bufs[k].to(dtypes[k])
            if later:
                sub = [states[k] for k in later]
                work, flat = self._work(sub, "momentum_buffer",
                                        [gs[k] for k in later],
                                        [dtypes[k] for k in later])
                torch._foreach_mul_(work, mu)
                torch._foreach_add_(work, [gs[k] for k in later])
                self._store(sub, "momentum_buffer", flat)
                for k, w in zip(later, work):
                    bufs[k] = w
            if group["nesterov"]:
                d = torch._foreach_add(gs, bufs, alpha=mu)
            else:
                d = bufs
        torch._foreach_add_(ps, d, alpha=-group["lr"])


class Adam(Optimizer):
    """torch.optim.Adam (weight decay coupled into the gradient) or, with
    ``decoupled``, AdamW (p *= 1 - lr * wd before the step)."""

    state_names = ("step", "exp_avg", "exp_avg_sq")

    def __init__(self, betas=(0.9, 0.999), eps=1e-8, decoupled=False,
                 state_dtype=None):
        super().__init__(state_dtype, betas=tuple(betas), eps=eps)
        self.decoupled = decoupled

    def _update(self, group, ps, gs, states, steps, dtypes):
        (b1, b2), eps = group["betas"], group["eps"]
        lr, wd = group["lr"], group["weight_decay"]
        if self.decoupled:
            torch._foreach_mul_(ps, 1 - lr * wd)
        elif wd:
            gs = torch._foreach_add(gs, ps, alpha=wd)
        m, m_flat = self._work(states, "exp_avg", gs, dtypes)
        v, v_flat = self._work(states, "exp_avg_sq", gs, dtypes)
        torch._foreach_lerp_(m, gs, 1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, gs, gs, value=1 - b2)
        self._store(states, "exp_avg", m_flat)
        self._store(states, "exp_avg_sq", v_flat)
        step_size = [-lr / (1 - b1 ** t) for t in steps]
        denom = torch._foreach_sqrt(v)
        torch._foreach_div_(denom, [(1 - b2 ** t) ** 0.5 for t in steps])
        torch._foreach_add_(denom, eps)
        torch._foreach_addcdiv_(ps, m, denom, step_size)


def sgd(momentum=0.9, nesterov=False, state_dtype=None, **_ignored):
    """torch.optim.SGD, its state in ``state_dtype`` when given."""
    return SGD(momentum=momentum, nesterov=nesterov, state_dtype=state_dtype)


def adam(betas=(0.9, 0.999), eps=1e-8, state_dtype=None, **_ignored):
    """torch.optim.Adam (weight decay coupled into the gradient)."""
    return Adam(betas, eps, decoupled=False, state_dtype=state_dtype)


def adamw(betas=(0.9, 0.999), eps=1e-8, state_dtype=None, **_ignored):
    """torch.optim.AdamW (weight decay decoupled)."""
    return Adam(betas, eps, decoupled=True, state_dtype=state_dtype)


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
