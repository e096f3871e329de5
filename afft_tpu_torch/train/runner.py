"""Train and eval steps of one model and optimizer configuration.

Port of afft_tpu/train/runner.py (reference common/runner.py:178-270 and the
optimizer / scheduler stepping of train.py:228-290). One ``train_step`` is
mixup, forward, losses, backward, gradient clipping and the optimizer
update; the host only computes the schedule's lr. Losses and metrics come
back as device tensors: nothing is read to the host unless the caller asks
(``check_nan``).

Precision. With ``compute_dtype=float32`` the model trains as it is. With
``compute_dtype=bfloat16`` the runner keeps the fp32 master model and a bf16
copy of it: forward and backward run on the copy (gradients arrive in bf16),
the optimizer updates the fp32 masters from the upcast gradients, and the
copy is refreshed from the masters (afft_tpu/train/runner.py:175-188,
:309-367).

The fuser blocks train through ``ops.fused_block_train`` (CUDA kernels,
forward and backward); ``impl="plain"`` runs their plain versions on the
same masks. Entry point: ``Runner.from_config`` on a composed expt config,
on the card unless the caller passes ``device="cpu"``.

Metrics accumulate on the device: a step given a ``MetricAccum`` adds its
losses, scalar metrics and MT5R hits to it, and ``absorb_accum`` reads it
into the ``MetricTracker`` once an epoch (afft_tpu/train/runner.py:113-172).
``watch_gradients`` adds the global gradient and parameter norms to the
metrics; ``class_weights`` weight the training loss only.

Host batches are copied to the card from pinned memory without blocking
(a copy from pageable memory waits until the stream has run everything
queued before it).

Data parallelism (a process group from ``parallel.mesh``): a step on R
processes computes the one-process step over the global batch, the ranks'
equal local batches concatenated in rank order (row i on rank r is global
row r * B_local + i, as afft_tpu/parallel/mesh.py:105-129 ``shard_batch``
assembles it). Four places would differ under a per-rank step, each marked
"DP (n)" below: (1) the gradients, (2) the loss normalisation, (3) mixup and
(4) dropout and drop-path. Every rank starts from the same weights and the
same generators, so every rank takes the same update.

Waiting (ROADMAP.md §A.7): ``grad_accum``, ``master_dtype=bfloat16``,
``param_shardings``, ``zero_sharding``, ``pipeline_stages``.
``from_config`` raises for each of those keys when a config sets it away
from its default.
"""

from __future__ import annotations

import copy
import functools
from typing import Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..config.registry import instantiate
from ..models import BaseModel
from ..models import layers as L
from ..parallel import mesh
from . import losses as LO
from . import optim as O
from .mixup import MixUp

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# elements of fp32 gradient reduced by one all-reduce (256 MB)
GRAD_BUCKET = 1 << 26

# train.* keys the JAX loop reads and the port does not honour yet, with
# their defaults (afft_tpu_torch/conf/config.yaml) and the roadmap item
UNPORTED_TRAIN_KEYS = (
    ("zero_sharding", False, "§A.7"),
    ("pipeline_stages", 0, "§A.7"),
)


def check_train_keys(train_cfg) -> None:
    """Raise for a train.* key the port does not honour, set away from its
    default (a config that sets one must not train without it)."""
    if (train_cfg.get("master_dtype") or "float32") != "float32" \
            or int(train_cfg.get("grad_accum") or 1) != 1:
        raise NotImplementedError(
            "train.master_dtype=bfloat16 and train.grad_accum > 1 are "
            "not ported (ROADMAP.md §A.7)")
    for key, default, item in UNPORTED_TRAIN_KEYS:
        value = train_cfg.get(key)
        if value is None or value == default:
            continue
        if key == "pipeline_stages" and int(value) <= 1:
            continue  # 0 and 1 run the stack unpipelined, as in JAX
        raise NotImplementedError(
            f"train.{key}={value} is not ported (ROADMAP.md {item})")


def global_norm(tensors):
    """sqrt of the sum of squares over every tensor, in fp32."""
    return torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm([t.float() for t in tensors])))


def clip_by_global_norm(grads, max_norm: float):
    """torch.nn.utils.clip_grad_norm_ semantics, in place on fp32 grads;
    returns the norm (a device tensor)."""
    norms = torch._foreach_norm(grads)
    gnorm = torch.linalg.vector_norm(torch.stack(norms))
    scale = torch.clamp(max_norm / (gnorm + 1e-6), max=1.0)
    torch._foreach_mul_(grads, scale)
    return gnorm


def _buckets(tensors, limit: int):
    """Consecutive groups of ``tensors`` of at most ``limit`` elements (a
    larger tensor alone)."""
    bucket, size = [], 0
    for t in tensors:
        if bucket and size + t.numel() > limit:
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += t.numel()
    if bucket:
        yield bucket


def reduce_gradients(grads) -> None:
    """DP (1): sum the fp32 gradients of the masters over the ranks, in
    place, in buckets of ``GRAD_BUCKET`` elements: one flat buffer a bucket,
    one all-reduce each. With the losses normalised over the global batch
    (DP (2)) the sum is the gradient of the global step.

    An explicit all-reduce and not DistributedDataParallel: DDP reduces the
    gradients of the module it wraps, which in bf16 is the compute copy, so
    it would sum bf16 gradients before their upcast; and it hooks
    ``forward``, while a step runs ``forward_train`` through the fused
    autograd Functions. Reducing after the upcast also lets
    ``watch_gradients`` and ``clip_by_global_norm`` read the global
    gradient."""
    if not mesh.active():
        return
    for bucket in _buckets(grads, GRAD_BUCKET):
        flat = torch._utils._flatten_dense_tensors(bucket)
        mesh.all_reduce_sum_([flat])
        for g, summed in zip(bucket, torch._utils._unflatten_dense_tensors(
                flat, bucket)):
            g.copy_(summed)


def global_mix(mix, x_video, labels, labels_subclips, valid=None):
    """DP (3): mixup over the global batch. The pre-mix rows of every rank
    are gathered (the backbones are the identity, so they are the input
    features and carry no gradient), the partner permutation, the mixable
    rows and the one lambda (the same generator on every rank) are the
    global batch's, and this rank keeps its own rows of the result."""
    rank, world = mesh.rank_and_world()
    rows = next(iter(x_video.values())).shape[0]
    gather = mesh.all_gather_cat

    def every(d):
        return None if d is None else {k: gather(v) for k, v in d.items()}
    out = mix(every(x_video), every(labels), every(labels_subclips),
              valid=None if valid is None else gather(valid))
    own = slice(rank * rows, (rank + 1) * rows)
    return tuple(None if d is None else {k: v[own] for k, v in d.items()}
                 for d in out)


def global_scalars(total, losses: Dict, metrics: Dict):
    """DP (2): the reported total, losses and scalar metrics as the global
    batch's: each rank holds its share of every mean (``losses``), and one
    all-reduce sums the shares. Without a process group, the values as they
    are, detached."""
    keys = [k for k, v in metrics.items() if not isinstance(v, dict)]
    vals = [total] + list(losses.values()) + [metrics[k] for k in keys]
    if mesh.active():
        summed = mesh.all_reduce_sum(
            torch.stack([v.detach().float() for v in vals])).unbind()
    else:
        summed = [v.detach() for v in vals]
    total = summed[0]
    losses = dict(zip(losses, summed[1:1 + len(losses)]))
    metrics = {**metrics, **dict(zip(keys, summed[1 + len(losses):]))}
    return total, losses, metrics


class MetricAccum:
    """An epoch's metrics, summed on the device (the JAX runner's in-step
    accumulator, afft_tpu/train/runner.py:113-146): each scalar loss or
    metric times the batch's valid rows, the valid count, and per MT5R
    metric the per-class top-5 hits and samples. Nothing is read back until
    ``Runner.absorb_accum``."""

    def __init__(self, num_classes: Dict[str, int]):
        self.num_classes = num_classes
        self.scalars: Dict[str, torch.Tensor] = {}
        self.mt5r: Dict[str, Dict[str, torch.Tensor]] = {}
        self.count = None

    def _classes_for(self, metric_name: str) -> int:
        found = None
        for t, c in self.num_classes.items():
            if t in metric_name:
                found = c
        if found is None:
            raise ValueError(f"no target in metric name {metric_name!r}")
        return found

    def add(self, losses: Dict, metrics: Dict, valid) -> None:
        n = valid.sum().float()
        self.count = n if self.count is None else self.count + n
        for k, v in {**losses, **metrics}.items():
            if isinstance(v, dict):
                continue
            v = v.detach().float() * n
            self.scalars[k] = v if k not in self.scalars \
                else self.scalars[k] + v
        for k, payload in metrics.items():
            if not isinstance(payload, dict):
                continue
            C = self._classes_for(k)
            labels = payload["labels"].reshape(-1)
            keep = payload["valid"].reshape(-1)
            tp = (payload["top5"] == labels[:, None]).any(dim=-1) & keep
            # -1 counts for the last class, as the JAX scatter indexes it
            idx = torch.where(labels < 0, labels + C, labels)
            state = self.mt5r.setdefault(k, {
                "tps": torch.zeros(C, device=labels.device),
                "nums": torch.zeros(C, device=labels.device)})
            state["tps"].index_add_(0, idx, tp.float())
            state["nums"].index_add_(0, idx, keep.float())


class Runner:
    """Owns the model, its optimizer and the steps."""

    def __init__(self, model, optimizer: O.Optimizer, groups: Dict,
                 loss_wts: Dict, mixup: Optional[MixUp] = None,
                 mixup_backbone: bool = True,
                 grad_clip: Optional[float] = None,
                 compute_dtype=torch.float32,
                 class_weights: Optional[Dict] = None, seed: int = 0,
                 impl: str = "kernel", watch_gradients: bool = False):
        self.model = model
        self.device = next(model.parameters()).device
        self.loss_wts = dict(loss_wts)
        self.mixup = mixup
        self.mixup_backbone = mixup_backbone
        self.grad_clip = grad_clip
        self.compute_dtype = compute_dtype
        self.impl = impl
        self.watch_gradients = watch_gradients
        self.class_weights = None if not class_weights else {
            t: torch.as_tensor(w, dtype=torch.float32, device=self.device)
            for t, w in class_weights.items()}
        # DP (4): the same generators on every rank; each draw is the
        # global batch's, of which a rank keeps its own rows
        self.rng = L.RngStream(seed, self.device, *mesh.rank_and_world())
        self.masters = [p for _, p in model.named_parameters()]
        self._mixed = compute_dtype != torch.float32
        if self._mixed:
            # the compute copy: same modules, parameters in compute_dtype
            self.net = copy.deepcopy(model).to(compute_dtype)
            self.compute = [p for _, p in self.net.named_parameters()]
        else:
            self.net, self.compute = model, self.masters
        self.optimizer = optimizer.bind(list(model.named_parameters()),
                                        groups)

    # ------------------------------------------------------------------
    @classmethod
    def from_config(cls, cfg, num_classes: Dict[str, int], *, device="cuda",
                    iters_per_epoch: int = 1, world_size: int = 1,
                    weights=None, impl: str = "kernel", compute_dtype=None,
                    class_mappings=None, class_weights=None):
        """Build the model, parameter groups, optimizer, schedule and mixup
        of a composed expt config (afft_tpu/train/loop.py:336-369). The
        model is drawn from ``cfg.seed`` unless ``weights`` (a state dict)
        is given; ``class_mappings`` become its verb / noun <-> action
        buffers. ``train.class_weight_beta`` needs ``class_weights`` ({target:
        (C,)}, from the train split's class counts: ``data.stats``, as the
        loop computes them). ``runner.lr_schedule(iteration,
        runner.base_lr)`` is the step's lr."""
        check_train_keys(cfg.train)
        if cfg.train.get("class_weight_beta") is not None \
                and not class_weights:
            raise ValueError("train.class_weight_beta needs the class "
                             "weights of the train split (class_weights=)")
        device = resolve_device(device)
        with torch.device(device):
            model = BaseModel(cfg.model, num_classes=num_classes,
                              class_mappings=class_mappings)
        seed = int(cfg.get("seed", 42))
        if weights is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            model.reset_parameters(gen)
        else:
            model.load_state_dict(weights, strict=True)
        groups = O.build_groups(list(model.named_parameters()),
                                cfg.opt.lr_wd, cfg.opt.lr, cfg.opt.wd)
        mixup = None
        if cfg.train.use_mixup:
            mixup = MixUp(alpha=cfg.train.mixup_alpha,
                          label_smoothing=dict(
                              cfg.train.label_smoothing.items()),
                          num_classes=num_classes)
        if compute_dtype is None:
            compute_dtype = cfg.model.get("compute_dtype") or "float32"
        if isinstance(compute_dtype, str):
            compute_dtype = DTYPES[compute_dtype]
        runner = cls(model, instantiate(cfg.opt.optimizer), groups,
                     loss_wts=dict(cfg.train.loss_wts.items()), mixup=mixup,
                     mixup_backbone=cfg.train.mixup_backbone,
                     grad_clip=cfg.opt.grad_clip,
                     compute_dtype=compute_dtype, seed=seed, impl=impl,
                     class_weights=class_weights,
                     watch_gradients=bool(cfg.train.get("watch_gradients")))
        runner.base_lr = float(cfg.opt.lr)
        runner.lr_schedule = O.build_schedule(cfg.opt, iters_per_epoch,
                                              world_size)
        return runner

    # ------------------------------------------------------------------
    def _to_device(self, batch):
        pin = self.device.type == "cuda"

        def move(v, dtype=None):
            t = torch.as_tensor(v)
            if pin and t.device.type == "cpu":
                # pinned, so the copy neither waits for the stream nor
                # blocks the host (a pageable copy does both); the loop's
                # loader pins its batches on its own thread
                if not t.is_pinned():
                    t = t.pin_memory()
                t = t.to(self.device, non_blocking=True)
            return t.to(self.device, dtype)
        out = {"data_dict": {m: move(v, self.compute_dtype)
                             for m, v in batch["data_dict"].items()},
               "target": {k: move(v, torch.long)
                          for k, v in batch["target"].items()}}
        sub = batch.get("target_subclips")
        out["target_subclips"] = None if sub is None else {
            k: move(v, torch.long) for k, v in sub.items()}
        valid = batch.get("valid")
        if valid is None:
            n = len(next(iter(out["target"].values())))
            out["valid"] = torch.ones(n, dtype=torch.bool,
                                      device=self.device)
        else:
            out["valid"] = move(valid, torch.bool)
        out["mixup_lam"] = batch.get("mixup_lam")
        return out

    def _forward(self, batch, *, train: bool, use_mixup: bool):
        data, target = batch["data_dict"], batch["target"]
        target_subclips, valid = batch["target_subclips"], batch["valid"]
        mixup_fn, ignore = None, None
        # batch["mixup_lam"] pins the Beta draw, so that a recorded
        # trajectory can be replayed exactly
        lam = batch["mixup_lam"]
        if use_mixup:
            mix = functools.partial(self.mixup.mix, lam) if lam is not None \
                else functools.partial(self.mixup, self.rng.gen)
            if mesh.active():
                mix = functools.partial(global_mix, mix)  # DP (3)
            if self.mixup_backbone:
                mixup_fn = functools.partial(mix, valid=valid)
            else:  # input-level mixup (reference runner.py:246-253)
                data, target, target_subclips, ignore = mix(
                    data, target, target_subclips, valid=valid)
        return self.net.forward_train(
            data, target=target, target_subclips=target_subclips,
            target_subclips_ignore_index=ignore, mixup_fn=mixup_fn,
            impl=self.impl, rng=self.rng if train else None)

    def _losses(self, outputs, outputs_target, valid, mixup_enable,
                train=True):
        losses, metrics = LO.compute_losses_metrics(
            outputs, outputs_target["target"],
            outputs_target["target_subclips"], mixup_enable=mixup_enable,
            target_subclips_ignore_index=outputs_target[
                "target_subclips_ignore_index"],
            valid=valid,
            class_weights=self.class_weights if train else None)
        return LO.reduce_losses(losses, self.loss_wts), losses, metrics

    # ------------------------------------------------------------------
    def train_step(self, batch, lr: float, base_lr: float,
                   check_nan: bool = False,
                   accum: Optional[MetricAccum] = None):
        """One iteration on ``batch`` ({"data_dict", "target",
        "target_subclips", "valid", "mixup_lam"}; numpy or tensors) at the
        schedule's ``lr``. Returns (losses with ``total_loss``, metrics),
        device tensors detached from the graph; ``accum`` gets both."""
        batch = self._to_device(batch)
        use_mixup = self.mixup is not None
        self.net.train()
        outputs, outputs_target = self._forward(batch, train=True,
                                                use_mixup=use_mixup)
        total, losses, metrics = self._losses(outputs, outputs_target,
                                              batch["valid"], use_mixup)
        for p in self.compute:
            p.grad = None
        total.backward()
        if self._mixed:
            # bf16 gradients of the compute copy -> fp32 on the masters
            for p, c in zip(self.masters, self.compute):
                p.grad = None if c.grad is None else c.grad.float()
                c.grad = None
        # DP (1), before the norms and the clipping read the gradient
        reduce_gradients(p.grad for p in self.masters if p.grad is not None)
        total, losses, metrics = global_scalars(total, losses, metrics)
        if self.watch_gradients:
            # the reference's wandb.watch(model) (train.py:416) as norms in
            # the metric stream (afft_tpu/train/runner.py:330-341): the
            # global norm, per top-level module, and of the parameters
            metrics = dict(metrics)
            by_module: Dict[str, list] = {}
            for (name, _), p in zip(self.model.named_parameters(),
                                    self.masters):
                if p.grad is not None:
                    by_module.setdefault(name.split(".")[0], []).append(
                        p.grad)
            metrics["grad_norm"] = global_norm(
                [g for gs in by_module.values() for g in gs])
            metrics["param_norm"] = global_norm(
                [p.detach() for p in self.masters])
            for key, grads in by_module.items():
                metrics[f"grad_norm_{key}"] = global_norm(grads)
        if self.grad_clip is not None:
            clip_by_global_norm([p.grad for p in self.masters
                                 if p.grad is not None], self.grad_clip)
        self.optimizer.step(lr / base_lr)
        if self._mixed:
            with torch.no_grad():
                torch._foreach_copy_(self.compute, self.masters)
        losses["total_loss"] = total
        if accum is not None:
            accum.add(losses, metrics, batch["valid"])
        if check_nan and bool(torch.isnan(losses["total_loss"])):
            raise ValueError("The loss is NaN!")
        return losses, metrics

    @torch.no_grad()
    def eval_step(self, batch, accum: Optional[MetricAccum] = None):
        """(losses with ``total_loss``, metrics, fp32 action logits (B, C) of
        the fused head or the first one, or None); ``accum`` gets the
        losses and metrics."""
        batch = self._to_device(batch)
        self.net.eval()
        outputs, outputs_target = self._forward(batch, train=False,
                                                use_mixup=False)
        total, losses, metrics = self._losses(
            outputs, outputs_target, batch["valid"], False, train=False)
        total, losses, metrics = global_scalars(total, losses, metrics)
        losses["total_loss"] = total
        if accum is not None:
            accum.add(losses, metrics, batch["valid"])
        action_logits = None
        if "logits/action" in outputs:
            heads = outputs["logits/action"]
            modk = "all-fused" if "all-fused" in heads else next(iter(heads))
            action_logits = heads[modk][:, 0, :].float()
        return losses, metrics, action_logits

    # ------------------------------------------------------------------
    def new_accum(self) -> MetricAccum:
        return MetricAccum(self.model.future_predictor.num_classes)

    @staticmethod
    def absorb_accum(metric_tracker, accum: Optional[MetricAccum],
                     is_training: bool) -> None:
        """The epoch's one readback into the host MetricTracker's meters
        (afft_tpu/train/runner.py:148-172)."""
        if accum is None or accum.count is None:
            return
        names = list(accum.scalars)
        host = torch.stack([accum.count] + [accum.scalars[k] for k in names]
                           ).cpu().numpy()
        count = float(host[0])
        if count == 0:
            return
        metrics = metric_tracker._metrics(is_training)
        prefix = "train_" if is_training else "val_"
        for key, total in zip(names, host[1:]):
            name = prefix + key
            if name not in metrics:
                metric_tracker.add_metric(name, is_training)
            meter = metrics[name]
            meter.sum = float(meter.sum) + float(total)
            meter.count += count
        for key, state in accum.mt5r.items():
            name = prefix + key
            if name not in metrics:
                metric_tracker.add_metric(name, is_training)
            meter = metrics[name]
            meter.tps = np.asarray(meter.tps) + state["tps"].cpu().numpy()
            meter.nums = np.asarray(meter.nums) + \
                state["nums"].cpu().numpy()

    @torch.no_grad()
    def load_model_state(self, state: Dict) -> None:
        """Load a state dict into the fp32 masters (strict) and refresh the
        compute copy from them."""
        self.model.load_state_dict(state, strict=True)
        if self._mixed:
            torch._foreach_copy_(self.compute, self.masters)

    def rng_state(self) -> Dict:
        """The training randomness (masks, mixup draws) as it stands, for a
        checkpoint: resuming from it continues the same streams."""
        return {"gen": self.rng.gen.get_state(),
                "host": self.rng._host.get_state()}

    def load_rng_state(self, state: Dict) -> None:
        self.rng.gen.set_state(state["gen"])
        self.rng._host.set_state(state["host"])
