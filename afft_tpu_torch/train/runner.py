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
:309-367). With ``train.master_dtype=bfloat16`` too, the bf16 weights are
the masters: no fp32 copy, the update runs in fp32 and is written back with
stochastic rounding, its bits from the runner's own generator (``sr_gen``,
seeded alike on every rank and apart from the dropout streams).

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
same generators, so every rank takes the same update. ``train.zero_sharding``
(ZeRO-1, ``parallel.sharding``) reduce-scatters the gradients instead, each
rank updates its slice and holds only its slice's optimizer state, and the
updated weights are all-gathered.

Gradient accumulation (``train.grad_accum`` = M,
afft_tpu/train/runner.py:246-307): each rank cuts its local batch into M
equal chunks; microbatch m is chunk m of every rank, and under the global
batch rule it is the global batch of one forward and backward. A step on R
ranks is thus one process's step over the global batch ordered
microbatch-major (``layers.RngStream.microbatch``). The fp32 gradients sum
weighted by each microbatch's valid rows over the step's, so a microbatch
without valid rows adds nothing; the losses and scalar metrics combine the
same way, and clip, reduction and update run once a step. Mixup draws one
lambda for each microbatch and pairs rows within it; dropout and drop-path
masks are drawn by the row's place in the whole step's global batch, so
with mixup off M microbatches on one process equal one pass. As in the JAX
package, a loss with its own denominator (class weights, ignored past
frames) combines as microbatch means weighted by valid rows.

Pipeline parallelism (``train.pipeline_stages`` = S > 1, GPipe;
``parallel.pipeline`` states the rules): the R processes form D = R / S data
replicas of S stages; each stage holds its share of the GPT-2 predictor's
layers and their optimizer state, and the rest of the model on every stage.
Everything data parallelism does above, DP (1)-(4), the microbatches of
``train.grad_accum`` and ZeRO-1, acts over the data group (the D ranks of
one stage) as it acts over the world without pipelining: a pipelined step
on D replicas is the one-process step over their global batch. The global
norms of clipping and ``watch_gradients`` add each stage's layers once and
the replicated rest once. ``checkpoint_state`` / ``load_checkpoint_state``
read and write the unpipelined layout.

Tensor parallelism (a ``grid`` with a model axis, ``parallel.sharding``
``make_mesh_2d`` / ``make_mesh_3d``; set by the caller, as no config key
sets it in the JAX package either; ``seq_parallel`` adds the GPT-2
predictor's ``SeqCtx``): the tp ranks of a replica hold the shards of one
model (``parallel.sharding.tensor_parallel``), see the same rows and draw
the same dropout, drop-path and mixup bits (the replica's ``row0``, never
the world rank's), and compute the rest of the model alike. Everything data
parallelism does acts over the data group (the replicas of one model rank
and stage). A sharded layer leaves its LayerNorms' gradients as partial
sums, summed over the model group before anything reads them; the global
norms add each shard once over the model group and a replicated tensor
once. Under sequence parallelism no replicated parameter is read on a
T-shard (each layer gathers T before its kernels and the stream is
gathered before ``ln_f``), so nothing more is summed. ZeRO-1 slices each
rank's local tensors over its data group. The checkpoint stays the
one-process file (the shards gathered over the model group) and loads at
any (data, model, pipe) layout.
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
from ..parallel import pipeline as P
from ..parallel import sharding as SH
from . import losses as LO
from . import optim as O
from .mixup import MixUp

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# the stochastic-rounding generator's seed offset from the run's seed
# (afft_tpu/train/runner.py:347-351 folds the same sentinel into its key)
SR_SEED = 0x5A7E57A6


def pipeline_stages(train_cfg) -> int:
    """``train.pipeline_stages``; 0 and 1 (unpipelined, as in JAX) are 1."""
    return max(int(train_cfg.get("pipeline_stages") or 0), 1)


def check_train_keys(train_cfg, model_cfg=None) -> None:
    """Raise for a train.* value the port refuses, as the JAX loop refuses
    it, from the config alone: a ``grad_accum`` below 1; under pipelining
    (``pipeline_stages`` > 1) a predictor depth ``fp_layers`` that the
    stages do not divide, or a microbatch count below 1. The process count
    is checked where the grid is made (``parallel.mesh.Grid``)."""
    accum = train_cfg.get("grad_accum")
    if accum is not None and int(accum) < 1:
        raise ValueError(f"train.grad_accum={accum}: it must be 1 or more")
    stages = pipeline_stages(train_cfg)
    if stages > 1:
        micro = train_cfg.get("pipeline_microbatches")
        if micro is not None and int(micro) < 1:
            raise ValueError(f"train.pipeline_microbatches={micro}: it must "
                             "be 1 or more")
        layers = None if model_cfg is None \
            else model_cfg.get("common", {}).get("fp_layers")
        if layers is not None and int(layers) % stages:
            raise ValueError(f"fp_layers={layers} must divide over "
                             f"pipeline_stages={stages}")


def global_square_sums(norms, slots, n_slots: int, group=None,
                       sharded: bool = False, owned=None, pipe=None,
                       split=None, model=None):
    """(n_slots,) sums of the whole model's squares: each tensor's norm
    (``norms``, 0-d device tensors) squared and added to its slot
    (``slots``), in a fixed order and with no host copy. ``sharded``: each
    rank holds slices (ZeRO-1), summed over the data ranks ``group``.
    ``owned`` (bools, the tensors of a pipeline stage's own layers): those
    are summed over the pipe group ``pipe``; ``split`` (bools, the
    tensor-parallel shards): those over the model group ``model``; the
    replicated rest is counted once."""
    kinds = [0] * len(slots)
    for flags, bit in ((owned, 1), (split, 2)):
        if flags is not None:
            kinds = [k | (bit if f else 0) for k, f in zip(kinds, flags)]
    parts = [[[] for _ in range(n_slots)] for _ in range(4)]
    for norm, slot, kind in zip(norms, slots, kinds):
        parts[kind][slot].append(norm)
    zero = norms[0].new_zeros((), dtype=torch.float32)
    sums = torch.stack([torch.stack([
        torch.stack(p).float().square().sum() if p else zero for p in row])
        for row in parts])
    if sharded:
        sums = mesh.all_reduce_sum(sums, group)
    rows = list(sums.unbind())
    for kind in (1, 2, 3):
        if kind & 1 and owned is not None:
            rows[kind] = mesh.all_reduce_sum(rows[kind], pipe)
        if kind & 2 and split is not None:
            rows[kind] = mesh.all_reduce_sum(rows[kind], model)
    return torch.stack(rows).sum(0)


def clip_by_global_norm(grads, max_norm: float, group=None,
                        sharded: bool = False, owned=None, pipe=None,
                        split=None, model=None):
    """torch.nn.utils.clip_grad_norm_ semantics, in place on fp32 grads;
    returns the norm (a device tensor), from ``global_square_sums`` of the
    tensors' norms (its ``group``, ``sharded``, ``owned``, ``pipe``,
    ``split`` and ``model``)."""
    gnorm = global_square_sums(torch._foreach_norm(grads), [0] * len(grads),
                               1, group, sharded, owned, pipe, split,
                               model)[0].sqrt()
    scale = torch.clamp(max_norm / (gnorm + 1e-6), max=1.0)
    torch._foreach_mul_(grads, scale)
    return gnorm


def reduce_gradients(grads, group=None) -> None:
    """DP (1): sum the fp32 gradients of the masters over the data ranks
    ``group`` (the world by default), in place, in buckets of
    ``mesh.GRAD_BUCKET`` elements: one flat buffer and one all-reduce a
    bucket. With the losses normalised over the global batch (DP (2)) the
    sum is the gradient of the global step.

    An explicit all-reduce and not DistributedDataParallel: DDP reduces the
    gradients of the module it wraps, which in bf16 is the compute copy, so
    it would sum bf16 gradients before their upcast; and it hooks
    ``forward``, while a step runs ``forward_train`` through the fused
    autograd Functions. Reducing after the upcast also lets
    ``watch_gradients`` and ``clip_by_global_norm`` read the global
    gradient."""
    if mesh.rank_and_world(group)[1] == 1:
        return
    for bucket in mesh.buckets(grads, mesh.GRAD_BUCKET):
        flat = torch._utils._flatten_dense_tensors(bucket)
        mesh.all_reduce_sum_([flat], group)
        for g, summed in zip(bucket, torch._utils._unflatten_dense_tensors(
                flat, bucket)):
            g.copy_(summed)


def global_mix(grid, mix, x_video, labels, labels_subclips, valid=None):
    """DP (3): mixup over the global batch of the data replicas of
    ``grid``. The pre-mix rows of every replica are gathered (the backbones
    are the identity, so they are the input features and carry no
    gradient), the partner permutation, the mixable rows and the one lambda
    (the same generator on every rank) are the global batch's, and this
    rank keeps its own rows of the result."""
    rows = next(iter(x_video.values())).shape[0]
    group = grid.data_group

    def gather(t):
        return mesh.all_gather_cat(t, group)

    def every(d):
        return None if d is None else {k: gather(v) for k, v in d.items()}
    out = mix(every(x_video), every(labels), every(labels_subclips),
              valid=None if valid is None else gather(valid))
    own = slice(grid.data * rows, (grid.data + 1) * rows)
    return tuple(None if d is None else {k: v[own] for k, v in d.items()}
                 for d in out)


def global_scalars(total, losses: Dict, metrics: Dict, group=None):
    """DP (2): the reported total, losses and scalar metrics as the global
    batch's: each rank holds its share of every mean (``losses``), and one
    all-reduce over the data ranks ``group`` sums the shares. Without a
    process group, the values as they are, detached."""
    keys = [k for k, v in metrics.items() if not isinstance(v, dict)]
    vals = [total] + list(losses.values()) + [metrics[k] for k in keys]
    if mesh.active():
        summed = mesh.all_reduce_sum(
            torch.stack([v.detach().float() for v in vals]), group).unbind()
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
                 impl: str = "kernel", watch_gradients: bool = False,
                 master_dtype=torch.float32, grad_accum: int = 1,
                 zero_sharding: bool = False,
                 pipeline: Optional[P.PipelineCtx] = None,
                 grid: Optional[mesh.Grid] = None,
                 tensor_parallel: Optional[SH.TensorParallel] = None):
        """``pipeline``: the model was split over its stages
        (``parallel.pipeline.split_model``) and ``groups`` cover the whole
        model. ``grid``: the process layout (default: the pipeline's, or
        the world's data parallelism); ``tensor_parallel``: the model was
        sharded over the grid's model group
        (``parallel.sharding.tensor_parallel``)."""
        if master_dtype != torch.float32 and master_dtype != compute_dtype:
            raise ValueError("train.master_dtype=bfloat16 requires "
                             "model.compute_dtype=bfloat16")
        self.model = model
        self.device = next(model.parameters()).device
        self.loss_wts = dict(loss_wts)
        self.mixup = mixup
        self.mixup_backbone = mixup_backbone
        self.grad_clip = grad_clip
        self.compute_dtype = compute_dtype
        self.master_dtype = master_dtype
        self.grad_accum = int(grad_accum)
        self.impl = impl
        self.watch_gradients = watch_gradients
        self.class_weights = None if not class_weights else {
            t: torch.as_tensor(w, dtype=torch.float32, device=self.device)
            for t, w in class_weights.items()}
        self.pipeline = pipeline
        self.tp = tensor_parallel
        # the data x pipe x model grid: every reduction of data parallelism
        # below runs over its data group (the world without pipelining or
        # tensor parallelism)
        if grid is None:
            grid = mesh.grid(1) if pipeline is None else pipeline.grid
        self.grid = grid
        self.groups = groups
        # DP (4): the same generators on every rank; each draw is the
        # global batch's, of which a data replica keeps its own rows
        self.rng = L.RngStream(seed, self.device, self.grid.data,
                               self.grid.replicas)
        self.sr_gen = None
        if master_dtype != torch.float32:
            # bf16 masters: the weights are the compute copy
            model.to(master_dtype)
            self.sr_gen = torch.Generator(device=self.device)
            self.sr_gen.manual_seed(int(seed) + SR_SEED)
        self.masters = [p for _, p in model.named_parameters()]
        self._copy = compute_dtype != master_dtype
        if self._copy:
            # the compute copy: same modules, parameters in compute_dtype
            self.net = copy.deepcopy(model).to(compute_dtype)
            self.compute = [p for _, p in self.net.named_parameters()]
        else:
            self.net, self.compute = model, self.masters
        self.optimizer = optimizer.bind(list(model.named_parameters()),
                                        groups)
        position = {id(p): i for i, p in enumerate(self.masters)}
        # the masters' index of each parameter the optimizer updates
        self._opt_index = [position[id(p)] for p in self.optimizer.params]
        # a pipeline stage's own layers (their norms add over the stages)
        self._owned = None if pipeline is None else [
            P.layer_of(name) is not None
            for name, _ in model.named_parameters()]
        # the tensor-parallel shards (their norms add over the model group)
        # and the gradients a sharded layer leaves partial
        self._split = self._partial = None
        if tensor_parallel is not None:
            names = [name for name, _ in model.named_parameters()]
            self._split = [n in tensor_parallel.specs for n in names]
            self._partial = [i for i, n in enumerate(names)
                             if n in tensor_parallel.partial]
        self.zero = None
        if zero_sharding:
            from ..parallel.sharding import Zero1
            self.zero = Zero1(self.masters, group=self.grid.data_group)
            self.optimizer.shard(self.zero, self._opt_index)

    # ------------------------------------------------------------------
    @classmethod
    def from_config(cls, cfg, num_classes: Dict[str, int], *, device="cuda",
                    iters_per_epoch: int = 1, world_size: int = 1,
                    weights=None, impl: str = "kernel", compute_dtype=None,
                    class_mappings=None, class_weights=None,
                    pipeline: bool = True, grid=None,
                    seq_parallel: bool = False):
        """Build the model, parameter groups, optimizer, schedule and mixup
        of a composed expt config (afft_tpu/train/loop.py:336-369), with
        the ``train.grad_accum``, ``train.master_dtype``,
        ``train.zero_sharding``, ``train.pipeline_stages`` /
        ``pipeline_microbatches`` and ``opt.optimizer.state_dtype`` options
        (ZeRO-1 and the pipeline's grid over the process group that exists
        when it is called; ``pipeline=False`` runs every layer in each
        process whatever the config says, as evaluation does). ``grid``
        (``parallel.sharding.make_mesh_2d`` / ``make_mesh_3d``): the layout
        instead, its stages the config's; a model axis of 2 or more ranks
        shards the model over it (tensor parallelism), and
        ``seq_parallel`` adds sequence parallelism to the GPT-2 predictor.
        ``world_size`` is the schedule's: the data replicas. The model is
        drawn from ``cfg.seed`` unless ``weights`` (a state dict of the
        whole model) is given; ``class_mappings`` become its verb / noun
        <-> action buffers. ``train.class_weight_beta`` needs
        ``class_weights`` ({target: (C,)}, from the train split's class
        counts: ``data.stats``, as the loop computes them). ``runner.lr_schedule(iteration,
        runner.base_lr)`` is the step's lr."""
        check_train_keys(cfg.train, cfg.model)
        stages = pipeline_stages(cfg.train) if pipeline else 1
        if grid is not None and grid.stages != stages:
            raise ValueError(f"a grid of {grid.stages} stages for "
                             f"train.pipeline_stages={stages}")
        if seq_parallel and (grid is None or grid.model_size < 2):
            raise ValueError("sequence parallelism needs a grid with a "
                             "model axis (make_mesh_2d(dp, tp), tp >= 2)")
        if seq_parallel and stages > 1:
            raise ValueError("seq_ctx and pipeline_ctx are mutually "
                             "exclusive")
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
        named = list(model.named_parameters())
        groups = O.build_groups(named, cfg.opt.lr_wd, cfg.opt.lr, cfg.opt.wd,
                                stages=stages)
        ctx = None
        if stages > 1:
            ctx = P.PipelineCtx(
                stages, int(cfg.train.get("pipeline_microbatches")
                            or stages),
                int(cfg.model.common.fp_layers),
                names=[n for n, _ in named], keys=list(model.state_dict()),
                grid=grid)
            P.split_model(model, ctx)
        del named
        tp = None
        if grid is not None and grid.model_size > 1:
            tp = SH.tensor_parallel(model, grid, seq_parallel)
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
                     watch_gradients=bool(cfg.train.get("watch_gradients")),
                     master_dtype=DTYPES[cfg.train.get("master_dtype")
                                         or "float32"],
                     grad_accum=int(cfg.train.get("grad_accum") or 1),
                     zero_sharding=bool(cfg.train.get("zero_sharding")),
                     pipeline=ctx, grid=grid, tensor_parallel=tp)
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
                mix = functools.partial(global_mix, self.grid, mix)  # DP (3)
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
            class_weights=self.class_weights if train else None,
            group=self.grid.data_group)
        return LO.reduce_losses(losses, self.loss_wts), losses, metrics

    # ------------------------------------------------------------------
    def train_step(self, batch, lr: float, base_lr: float,
                   check_nan: bool = False,
                   accum: Optional[MetricAccum] = None):
        """One iteration on ``batch`` ({"data_dict", "target",
        "target_subclips", "valid", "mixup_lam"}; numpy or tensors) at the
        schedule's ``lr``. Returns (losses with ``total_loss``, metrics),
        device tensors detached from the graph; ``accum`` gets both.
        ``mixup_lam`` pins lambda: one value, or one a microbatch."""
        batch = self._to_device(batch)
        if self.pipeline is not None:
            rows, parts = len(batch["valid"]), \
                self.grad_accum * self.pipeline.microbatches
            if rows % parts:
                raise ValueError(
                    f"a local batch of {rows} rows does not divide into "
                    f"train.grad_accum={self.grad_accum} x "
                    f"pipeline_microbatches={self.pipeline.microbatches}")
        use_mixup = self.mixup is not None
        self.net.train()
        # the last step's gradients go before this step's activations come
        for p in self.masters + self.compute:
            p.grad = None
        if self.grad_accum == 1:
            outputs, outputs_target = self._forward(batch, train=True,
                                                    use_mixup=use_mixup)
            total, losses, metrics = self._losses(
                outputs, outputs_target, batch["valid"], use_mixup)
            total.backward()
            grads = self._fp32_grads()
        else:
            total, losses, metrics, grads = self._accumulate(batch,
                                                             use_mixup)
        for p in self.compute:
            p.grad = None
        if self._partial:
            # a sharded layer's LayerNorm gradients: partial sums over the
            # model group
            mesh.all_reduce_sum_([grads[i] for i in self._partial
                                  if grads[i] is not None],
                                 self.grid.model_group)
        if self.master_dtype == torch.float32 and self.zero is None:
            # fp32 masters keep the step's whole gradient in .grad, reduced
            # and clipped in place (as clip_grad_norm_ leaves it); the
            # optimizer step reads it and does not change it
            for p, g in zip(self.masters, grads):
                p.grad = g
        # DP (1), before the norms and the clipping read the gradient
        if self.zero is None:
            reduce_gradients((g for g in grads if g is not None),
                             self.grid.data_group)
        else:
            grads = self.zero.reduce_scatter(grads)  # this rank's pieces
        total, losses, metrics = global_scalars(total, losses, metrics,
                                                self.grid.data_group)
        if self.watch_gradients:
            metrics = {**metrics, **self._norms(grads)}
        if self.grad_clip is not None:
            have = [i for i, g in enumerate(grads) if g is not None]
            clip_by_global_norm(
                [grads[i] for i in have], self.grad_clip,
                self.grid.data_group, self.zero is not None,
                **self._split_args(have))
        self.optimizer.step(lr / base_lr,
                            [grads[i] for i in self._opt_index],
                            gen=self.sr_gen)
        with torch.no_grad():
            if self.zero is not None:
                self.zero.all_gather()
            if self._copy:
                torch._foreach_copy_(self.compute, self.masters)
        losses["total_loss"] = total
        if accum is not None:
            accum.add(losses, metrics, batch["valid"])
        if check_nan and bool(torch.isnan(losses["total_loss"])):
            raise ValueError("The loss is NaN!")
        return losses, metrics

    def _accumulate(self, batch, use_mixup):
        """``train.grad_accum`` = M: M forward and backward passes over the
        local batch's M chunks (the class docstring's rule). Returns this
        rank's share of the total, losses and scalar metrics (the
        microbatches' shares weighted by their valid rows, for
        ``global_scalars`` to sum), the metrics' MT5R payloads stitched back
        to the local batch's rows, and the fp32 gradients aligned with the
        masters."""
        M, valid = self.grad_accum, batch["valid"]
        rows = valid.shape[0]
        if rows % M:
            raise ValueError(f"train.grad_accum={M} must divide the batch "
                             f"of {rows} rows (a process)")
        b = rows // M
        # the step's valid rows by microbatch, over every rank
        counts = mesh.all_reduce_sum(valid.reshape(M, b).sum(1).float(),
                                     self.grid.data_group)
        weights = counts / counts.sum().clamp(min=1.0)
        lams = batch["mixup_lam"]
        if lams is None and use_mixup:
            lams = [self.mixup.draw(self.rng.gen) for _ in range(M)]
        elif lams is not None and np.ndim(lams) == 0:
            lams = [lams] * M
        start = (self.rng.gen.get_state(), self.rng._host.get_state())
        # bf16 gradients are summed in fp32 here, an fp32 model's in its own
        # .grad by autograd
        upcast = self.compute_dtype != torch.float32
        grads, shares, payloads = None, [], []
        for m in range(M):
            part = slice(m * b, (m + 1) * b)

            def cut(d):
                return None if d is None else {k: v[part]
                                               for k, v in d.items()}
            micro = {"data_dict": cut(batch["data_dict"]),
                     "target": cut(batch["target"]),
                     "target_subclips": cut(batch["target_subclips"]),
                     "valid": valid[part],
                     "mixup_lam": None if lams is None else lams[m]}
            # every microbatch draws over the step's whole global batch
            self.rng.gen.set_state(start[0])
            self.rng._host.set_state(start[1])
            with self.rng.microbatch(m, M):
                outputs, outputs_target = self._forward(
                    micro, train=True, use_mixup=use_mixup)
            total, losses, metrics = self._losses(
                outputs, outputs_target, micro["valid"], use_mixup)
            (total * weights[m]).backward()
            if upcast:
                if m == 0:
                    grads = self._fp32_grads()
                else:
                    # one multi-tensor add of the bf16 gradients into the
                    # fp32 sums: no copy of them
                    torch._foreach_add_(
                        [g for g in grads if g is not None],
                        [c.grad for c in self.compute if c.grad is not None])
                for c in self.compute:
                    c.grad = None
            scalars = {"": total, **losses,
                       **{k: v for k, v in metrics.items()
                          if not isinstance(v, dict)}}
            shares.append({k: v.detach().float() * weights[m]
                           for k, v in scalars.items()})
            payloads.append({k: v for k, v in metrics.items()
                             if isinstance(v, dict)})
        if not upcast:
            grads = [c.grad for c in self.compute]
        combined = {k: sum(s[k] for s in shares) for k in shares[0]}
        total = combined.pop("")
        losses = {k: combined[k] for k in losses}
        metrics = {k: combined[k] if k in combined else
                   {f: torch.cat([p[k][f] for p in payloads])
                    for f in payloads[0][k]} for k in metrics}
        return total, losses, metrics, grads

    def _fp32_grads(self):
        """The compute copy's gradients in fp32, aligned with the masters
        (None where there is none): an fp32 model's own, else upcast copies
        (views of one flat buffer)."""
        have = [c.grad for c in self.compute if c.grad is not None]
        if self.compute_dtype == torch.float32 or not have:
            return [c.grad for c in self.compute]
        up = iter(O.upcast(have)[1])
        return [None if c.grad is None else next(up) for c in self.compute]

    def _split_args(self, index):
        """``global_square_sums``' pipeline and tensor-parallel arguments
        for the tensors at ``index`` of the masters: which are the stage's
        own and the pipe group, which are shards and the model group; none
        without either."""
        index = list(index)
        out = {}
        if self._owned is not None:
            out.update(owned=[self._owned[i] for i in index],
                       pipe=self.grid.pipe_group)
        if self._split is not None:
            out.update(split=[self._split[i] for i in index],
                       model=self.grid.model_group)
        return out

    def _norms(self, grads):
        """``watch_gradients``: the reference's wandb.watch(model)
        (train.py:416) as norms in the metric stream
        (afft_tpu/train/runner.py:330-341): the global gradient norm before
        clipping, per top-level module, and the parameters' norm. Under
        ZeRO-1 each rank's pieces give square sums that one all-reduce
        adds up; under pipelining the stages' own layers add up over the
        pipe group, under tensor parallelism the shards over the model
        group."""
        modules: Dict[str, int] = {}
        which, present, index = [], [], []
        for i, ((name, _), g) in enumerate(zip(self.model.named_parameters(),
                                               grads)):
            if g is not None:
                which.append(modules.setdefault(name.split(".")[0],
                                                len(modules)))
                present.append(g)
                index.append(i)
        sums = global_square_sums(torch._foreach_norm(present), which,
                                  len(modules),
                                  self.grid.data_group, self.zero is not None,
                                  **self._split_args(index))
        # the masters are whole on every rank, ZeRO-1 or not
        param_norm = global_square_sums(
            torch._foreach_norm([p.detach() for p in self.masters], 2,
                                dtype=torch.float32),
            [0] * len(self.masters), 1,
            **self._split_args(range(len(self.masters))))[0].sqrt()
        out = {"grad_norm": sums.sum().sqrt(), "param_norm": param_norm}
        for key, j in modules.items():
            out[f"grad_norm_{key}"] = sums[j].sqrt()
        return out

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
        total, losses, metrics = global_scalars(total, losses, metrics,
                                                self.grid.data_group)
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
        """Load a state dict into the masters (strict; each tensor cast to
        the masters' dtype, so fp32 and bf16-master checkpoints load either
        way) and refresh the compute copy from them. A pipeline stage takes
        its part of a whole model's state dict, a tensor-parallel rank its
        shards."""
        if self.pipeline is not None:
            state = P.local_model_state(self.pipeline, state)
        if self.tp is not None:
            state = SH.shard_state(self.tp, state)
        self.model.load_state_dict(state, strict=True)
        if self._copy:
            torch._foreach_copy_(self.compute, self.masters)

    def model_state(self) -> Dict:
        """The model state dict in the one-process layout: under tensor
        parallelism the shards gathered over the model group, under
        pipelining every stage's layers gathered to rank 0 (every rank calls
        it together; the others get their own part)."""
        state = self.model.state_dict()
        if self.tp is not None:
            state = SH.canonical_state(self.tp, state)
        if self.pipeline is not None:
            state = P.canonical_model_state(self.pipeline, state)
        return state

    def _tp_optimizer_state(self, opt: Dict, gather: bool) -> Dict:
        """The optimizer state dict (indices in this rank's order) with each
        shard's state tensors gathered over the model group (``gather``),
        or whole ones cut to this rank's shards."""
        state = {}
        for i, entry in opt["state"].items():
            spec = self.tp.specs.get(self.optimizer.names[int(i)])
            state[i] = dict(entry)
            for k, v in entry.items():
                if spec is None or not torch.is_tensor(v) or v.dim() == 0:
                    continue
                if gather:
                    parts = mesh.all_gather_cat(v.contiguous()[None],
                                                self.grid.model_group)
                    state[i][k] = SH.unshard_tensor(list(parts), spec)
                else:
                    state[i][k] = SH.shard_tensor(v, spec, self.tp.rank,
                                                  self.tp.count)
        return {**opt, "state": state}

    def checkpoint_state(self):
        """(model state dict, optimizer state dict) in the one-process
        layout: whole tensors under ZeRO-1 and tensor parallelism, every
        layer under pipelining (gathered to rank 0, which alone writes).
        Every rank must call it together."""
        opt = self.optimizer.state_dict()
        if self.tp is not None:
            opt = self._tp_optimizer_state(opt, gather=True)
        if self.pipeline is not None:
            opt = P.canonical_optimizer_state(self.pipeline, self.optimizer,
                                              opt, self.groups)
        return self.model_state(), opt

    def load_checkpoint_state(self, model: Dict, optimizer: Dict) -> None:
        """The counterpart of ``checkpoint_state``: a checkpoint written by
        any run, pipelined or not, sharded (ZeRO-1, tensor parallelism) or
        not."""
        self.load_model_state(model)
        if self.pipeline is not None:
            optimizer = P.local_optimizer_state(self.pipeline, self.optimizer,
                                                optimizer, self.groups)
        if self.tp is not None:
            optimizer = self._tp_optimizer_state(optimizer, gather=False)
        self.optimizer.load_state_dict(optimizer)

    def rng_state(self) -> Dict:
        """The training randomness (masks, mixup draws, stochastic
        rounding) as it stands, for a checkpoint: resuming from it continues
        the same streams."""
        state = {"gen": self.rng.gen.get_state(),
                 "host": self.rng._host.get_state()}
        if self.sr_gen is not None:
            state["sr"] = self.sr_gen.get_state()
        return state

    def load_rng_state(self, state: Dict) -> None:
        self.rng.gen.set_state(state["gen"])
        self.rng._host.set_state(state["host"])
        if self.sr_gen is not None and "sr" in state:
            self.sr_gen.set_state(state["sr"])
