"""GPipe pipeline parallelism of the GPT-2 predictor stack over processes.

Port of afft_tpu/parallel/pipeline.py (``pipeline_blocks`` /
``_pipeline_schedule`` :134-240, ``make_mesh_data_pipe`` :252-262,
``check_uniform_layer_groups`` :79-111) and of its wiring in
afft_tpu/train/loop.py:304-332, for ``train.pipeline_stages`` = S > 1 and
``train.pipeline_microbatches`` = M (default S). The JAX package runs the
schedule as one ``lax.scan`` inside ``shard_map`` over a ``pipe`` mesh axis;
here each stage is a process and the schedule is written out tick by tick,
eagerly, with the hops as point-to-point messages. The semantics kept:

1. Process grid (``parallel.mesh.Grid``): R = D·S processes; rank r is data
   replica r // S and stage r % S. The data group (the ranks of one stage)
   carries everything plain data parallelism carries: the gradient
   all-reduce, the loss denominators, the mixup gather, ZeRO-1, the
   metrics. The pipe group (the ranks of one replica) carries the
   activations and their gradients. Every global-batch rule of data
   parallelism holds over the D replicas, never over the world of D·S
   processes, and the lr schedule's ``world_size`` is D, so a pipelined run
   keeps the unpipelined run's schedule.
2. Ownership: stage s holds the weights, gradients and optimizer state of
   layers [s·L/S, (s+1)·L/S) only (``BaseFuturePredictor.pipeline`` drops
   the others' modules). Everything else (mapping, fuser, ``wpe``, ``ln_f``,
   decoder, classifiers) is replicated on every rank of the pipe group and
   computed identically there, as JAX's schedule leaves it.
3. The schedule (``StackPass``): each pass of the stack is cut into M
   microbatches; all forwards run (tick t: stage s runs microbatch t - s),
   then all backwards in reverse microbatch order (tick t: stage s runs
   microbatch M - 1 - (t - (S - 1 - s))). Activations hop to the next
   stage and their gradients to the previous one. Where JAX computes
   throwaway work on a bubble tick, a rank here skips it. The last stage's
   output is broadcast over the pipe group (JAX's ``psum`` of the last
   stage's buffer, :230-235), so every rank computes the heads and losses
   alike; stage 0's input gradient is broadcast too, so the replicated
   layers' backward is the same on every rank.
4. Masks: each stage runs its layers through
   ``ops.fused_gpt2_train.fused_gpt2_block_train`` with ``layer_idx`` the
   global layer index and ``row0`` the microbatch's first global row, so
   the Philox masks are the unpipelined step's: a pipelined step with
   dropout, drop-path and mixup equals the one-process unpipelined step
   over the same global batch. This differs from JAX, whose pipelined
   masks fold the microbatch index into threefry keys
   (afft_tpu/models/predictor.py:192-227); no port reproduces those bit for
   bit, so the port is held against JAX at dropout 0, as
   tests/test_integration.py holds JAX's own pipelined step.
5. Eval: validation runs the same stages through ``ops.fused_gpt2``'s
   ``fused_gpt2_block`` (JAX's eval under ``pipeline_ctx``). The attention
   weights (``collect_attn``) need every layer on one rank and are refused
   under pipelining; a multi-step eval rollout re-runs the sequence through
   the stages instead of the one-rank KV cache.
6. Checkpoints stay canonical (``canonical_model_state`` /
   ``canonical_optimizer_state``, like ``unstack_predictor_blocks``): rank
   0 gathers every stage's layers and their optimizer state into the
   unpipelined layout and alone writes it; a resume hands each stage its
   slice (``local_model_state`` / ``local_optimizer_state``), so a
   checkpoint of either kind loads in either kind of run.
7. Guards, as JAX refuses: S must divide the process count,
   ``fp_layers % S == 0``, the local batch must divide into ``grad_accum``
   × M, and a per-layer ``opt.lr_wd`` rule raises
   (``check_uniform_layer_groups``). 0 and 1 stage run unpipelined.

A failed send or receive raises on the rank that sees it, and the process
group's timeout fails the others: no rank carries on alone, and no stage
falls back to another path.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from . import mesh
from ..train.optim import group_layout

# a predictor layer's parameter or state-dict name: (predictor prefix,
# layer index, name within the layer)
LAYER_NAME = re.compile(r"^(.*gpt_model\.h\.)(\d+)\.(.+)$")


def layer_of(name: str):
    """(predictor prefix, global layer index) of a pipelined layer's name,
    else None."""
    m = LAYER_NAME.match(name)
    return None if m is None else (m.group(1), int(m.group(2)))


def check_uniform_layer_groups(groups: Dict) -> None:
    """Raise when ``opt.lr_wd`` gives the layers of a predictor different
    lr / wd groups ({parameter name: GroupSpec}, over the whole model),
    with afft_tpu/parallel/pipeline.py:79-111's message: the JAX package
    stacks the layers into one leaf under pipelining, where such a rule can
    no longer match, and refuses it."""
    layers: Dict[str, Dict[int, list]] = {}
    for name, spec in groups.items():
        m = LAYER_NAME.match(name)
        if m is not None:
            layers.setdefault(m.group(1), {}).setdefault(
                int(m.group(2)), []).append((m.group(3), spec))
    bad = []
    for prefix, by_layer in layers.items():
        first = by_layer[min(by_layer)]
        bad += [f"{prefix}{i}" for i, specs in sorted(by_layer.items())
                if specs != first]
    if bad:
        raise ValueError(
            "opt.lr_wd assigns different lr/wd groups to individual "
            f"predictor layers ({', '.join(bad)}), which is inexpressible "
            "under the stacked predictor storage used when "
            "train.pipeline_stages>1 — drop the per-layer rule or train "
            "without pipeline parallelism.")


class PipelineCtx:
    """One pipelined run's handle (the counterpart of JAX's
    ``PipelineCtx``): the stage count, the microbatch count, the grid of
    this process (``mesh.grid``, or a given one with a model axis: the
    stages of one model rank exchange its shards' activations), the layers
    this stage owns of an
    ``n_layer`` stack, and the canonical names of the whole model (its
    parameter names ``names`` and state-dict keys ``keys``, in order) that
    the checkpoints are written in."""

    def __init__(self, stages: int, microbatches: int, n_layer: int,
                 names=(), keys=(), grid=None):
        if n_layer % stages:
            raise ValueError(f"fp_layers={n_layer} must divide over "
                             f"pipeline_stages={stages}")
        self.grid = mesh.grid(stages) if grid is None else grid
        if self.grid.stages != stages:
            raise ValueError(f"a grid of {self.grid.stages} stages for "
                             f"pipeline_stages={stages}")
        self.stages, self.microbatches = int(stages), int(microbatches)
        per = n_layer // stages
        self.stage = self.grid.stage
        self.layers = range(self.stage * per, (self.stage + 1) * per)
        self.names, self.keys = list(names), list(keys)

    def __deepcopy__(self, memo):
        # the process groups are shared, not copied (the runner's compute
        # copy of the model keeps this handle)
        return self

    def rank_of(self, stage: int) -> int:
        """The global rank of ``stage`` in this process's replica."""
        return self.grid.pipe_ranks[stage]

    def owns(self, name: str) -> bool:
        """Whether this stage holds the tensor ``name`` (a replicated one,
        or one of its own layers)."""
        at = layer_of(name)
        return at is None or at[1] in self.layers


class StackPass:
    """One pass of a batch through the pipelined stack. ``stage_fn(h, m)``
    runs this stage's layers (``params``) on microbatch m (the caller gives
    each layer its global index and m's first global row). ``forward``
    returns the stack's output on every rank of the pipe group; with
    ``grad`` it keeps each microbatch's graph for ``backward``, which takes
    the output's gradient and returns the input's, on every rank, and adds
    the pass's parameter gradients to their ``.grad``: each microbatch's
    gradient arrives in the compute dtype (rounded once a microbatch under
    bf16, where one pass over the whole batch rounds its product once),
    the microbatches' are summed in fp32 and the sum is cast to the
    parameter's dtype."""

    def __init__(self, ctx: PipelineCtx, stage_fn, params=()):
        self.ctx, self.stage_fn = ctx, stage_fn
        self.params = [p for p in params if p.requires_grad]

    def forward(self, x: torch.Tensor, grad: bool) -> torch.Tensor:
        ctx = self.ctx
        S, M, s = ctx.stages, ctx.microbatches, ctx.stage
        if x.shape[0] % M:
            raise ValueError(f"a batch of {x.shape[0]} rows does not divide "
                             f"into pipeline_microbatches={M}")
        self.rows = x.shape[0] // M
        self.shape, self.dtype = (self.rows,) + tuple(x.shape[1:]), x.dtype
        micro = x.split(self.rows)
        self.ins: List[Optional[torch.Tensor]] = [None] * M
        self.outs: List[Optional[torch.Tensor]] = [None] * M
        # the GPipe forward, tick by tick (_pipeline_schedule's ``tick``)
        for t in range(M + S - 1):
            m = t - s                      # stage s runs microbatch t - s
            if not 0 <= m < M:
                continue                   # a bubble tick
            h = micro[m] if s == 0 else mesh.recv(
                self.shape, self.dtype, x.device, ctx.rank_of(s - 1))
            if grad:
                h = h.detach().requires_grad_()
            with torch.set_grad_enabled(grad):
                out = self.stage_fn(h, m)
            if s < S - 1:
                mesh.send(out.detach(), ctx.rank_of(s + 1))
            if grad:
                self.ins[m] = h
            if grad or s == S - 1:
                self.outs[m] = out
        # the last stage's output on every rank of the pipe group
        if s == S - 1:
            result = torch.cat([o.detach() for o in self.outs])
        else:
            result = x.new_empty(x.shape)
        if not grad:
            self.outs = [None] * M
        return mesh.broadcast(result, ctx.rank_of(S - 1),
                              ctx.grid.pipe_group)

    def backward(self, g: torch.Tensor) -> torch.Tensor:
        ctx = self.ctx
        S, M, s = ctx.stages, ctx.microbatches, ctx.stage
        grads = g.split(self.rows)
        dx: List[Optional[torch.Tensor]] = [None] * M
        sums = None
        # all backwards, in reverse microbatch order, tick by tick
        for t in range(M + S - 1):
            m = M - 1 - (t - (S - 1 - s))
            if not 0 <= m < M:
                continue
            gm = grads[m].contiguous() if s == S - 1 else mesh.recv(
                self.shape, g.dtype, g.device, ctx.rank_of(s + 1))
            d, *pg = torch.autograd.grad(self.outs[m],
                                         [self.ins[m]] + self.params, gm)
            if s > 0:
                mesh.send(d, ctx.rank_of(s - 1))
            else:
                dx[m] = d
            self.ins[m] = self.outs[m] = None   # this microbatch's graph
            if sums is None:
                sums = [t.float() for t in pg]
            else:
                torch._foreach_add_(sums, pg)
        for p, total in zip(self.params, sums or ()):
            total = total.to(p.dtype)
            p.grad = total if p.grad is None else p.grad + total
        result = torch.cat(dx) if s == 0 else g.new_empty(
            (self.rows * M,) + self.shape[1:], dtype=self.dtype)
        return mesh.broadcast(result, ctx.rank_of(0), ctx.grid.pipe_group)


class _Stack(torch.autograd.Function):
    """The pipelined stack under autograd: its backward runs the stages'
    backward schedule (the stages' parameter gradients accumulate into
    their ``.grad``) and returns the input's gradient."""

    @staticmethod
    def forward(fctx, x, run):
        fctx.run = run
        return run.forward(x, grad=True)

    @staticmethod
    def backward(fctx, g):
        run, fctx.run = fctx.run, None
        return run.backward(g), None


def run_stack(ctx: PipelineCtx, x: torch.Tensor, stage_fn,
              params=()) -> torch.Tensor:
    """x (B, T, C) through the pipelined stack; differentiable when grad
    mode is on (the stage's ``params`` get their gradients in the backward
    even where x needs none)."""
    run = StackPass(ctx, stage_fn, params)
    if not torch.is_grad_enabled():
        return run.forward(x, grad=False)
    if not x.requires_grad:
        x = x.detach().requires_grad_()
    return _Stack.apply(x, run)


def split_model(model: torch.nn.Module, ctx: PipelineCtx) -> None:
    """Pipeline every GPT-2 predictor of ``model`` over ``ctx``'s stages:
    each keeps this stage's layers and drops the others'."""
    from ..models.predictor import BaseFuturePredictor
    for module in list(model.modules()):
        if isinstance(module, BaseFuturePredictor):
            module.pipeline(ctx)


# -- canonical checkpoints --------------------------------------------------

def _gather_stages(ctx: PipelineCtx, mine: Dict) -> Optional[List[Dict]]:
    """Every stage's ``mine`` ({key: tensor}) on stage 0 of replica 0
    (global rank 0) as host tensors, in stage order; None elsewhere. The
    ranks of replica 0 call it together: the keys, shapes and dtypes
    travel as one small object, each tensor by ``mesh.send`` / ``recv``."""
    meta = {k: (tuple(v.shape), v.dtype) for k, v in mine.items()}
    metas = [None] * ctx.stages if ctx.stage == 0 else None
    dist.gather_object(meta, metas, dst=ctx.rank_of(0),
                       group=ctx.grid.pipe_group)
    if ctx.stage != 0:
        for v in mine.values():
            mesh.send(v, ctx.rank_of(0))
        return None
    parts = [{k: _host(v) for k, v in mine.items()}]
    for stage in range(1, ctx.stages):
        parts.append({k: mesh.recv(shape, dtype, "cpu", ctx.rank_of(stage))
                      for k, (shape, dtype) in metas[stage].items()})
    return parts


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def canonical_model_state(ctx: PipelineCtx, local: Dict) -> Dict:
    """The unpipelined model state dict (every layer, the canonical key
    order) on rank 0, from each stage's ``local`` one; every rank of replica
    0 takes part (under tensor parallelism those of model rank 0, after the
    model group's gather). Other ranks get ``local`` back (they write
    nothing)."""
    if ctx.grid.data != 0 or ctx.grid.model != 0:
        return local
    parts = _gather_stages(ctx, {k: v for k, v in local.items()
                                 if layer_of(k) is not None})
    if parts is None:
        return local
    merged = {k: v for k, v in local.items() if layer_of(k) is None}
    for part in parts:
        merged.update(part)
    if set(merged) != set(ctx.keys):
        raise RuntimeError("the stages' model states do not make up the "
                           "canonical one")
    return {k: merged[k] for k in ctx.keys}


def local_model_state(ctx: PipelineCtx, state: Dict) -> Dict:
    """This stage's part of a canonical (or this stage's own) model state
    dict: the replicated tensors and its own layers'."""
    return {k: v for k, v in state.items() if ctx.owns(k)}


def canonical_optimizer_state(ctx: PipelineCtx, optimizer, local: Dict,
                              groups: Dict) -> Dict:
    """The unpipelined optimizer state dict (torch.optim's layout, indices
    in the canonical parameter order) on rank 0, from this stage's
    ``local`` one (``optimizer.state_dict()``, whole tensors); every rank of
    replica 0 (and model rank 0) takes part."""
    if ctx.grid.data != 0 or ctx.grid.model != 0:
        return local
    by_name = {optimizer.names[int(i)]: entry
               for i, entry in local["state"].items()}
    parts = _gather_stages(ctx, {
        (n, k): v for n, e in by_name.items() if layer_of(n) is not None
        for k, v in e.items()})
    if parts is None:
        return local
    for part in parts:
        for (n, k), v in part.items():
            by_name.setdefault(n, {})[k] = v
    layout = group_layout(ctx.names, groups)
    if len(layout) != len(local["param_groups"]):
        raise RuntimeError("the stages' parameter groups differ from the "
                           "canonical ones")
    state, param_groups, index = {}, [], 0
    for (_, names), group in zip(layout, local["param_groups"]):
        ids = list(range(index, index + len(names)))
        for i, n in zip(ids, names):
            if n in by_name:
                state[i] = by_name[n]
        param_groups.append({**group, "params": ids})
        index += len(names)
    return {"state": state, "param_groups": param_groups}


def local_optimizer_state(ctx: PipelineCtx, optimizer, canonical: Dict,
                          groups: Dict) -> Dict:
    """This stage's optimizer state dict from a canonical one (indices in
    this stage's parameter order)."""
    names = [n for _, ns in group_layout(ctx.names, groups) for n in ns]
    if len(canonical["param_groups"]) != len(optimizer.param_groups):
        raise ValueError("the optimizer state does not match the "
                         "parameter groups")
    position = {n: i for i, n in enumerate(optimizer.names)}
    state = {position[names[int(i)]]: entry
             for i, entry in canonical["state"].items()
             if names[int(i)] in position}
    param_groups, index = [], 0
    for saved, mine in zip(canonical["param_groups"], optimizer.param_groups):
        n = len(mine["params"])
        param_groups.append({**saved, "params": list(range(index,
                                                           index + n))})
        index += n
    return {"state": state, "param_groups": param_groups}
