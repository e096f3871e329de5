"""ZeRO-1, tensor parallelism and sequence parallelism over processes.

Tensor parallelism (Megatron's column- and row-parallel products over the
model group of ``parallel.mesh.Grid``): the counterpart of
afft_tpu/parallel/sharding.py:30-46 ``TP_RULES``, :82-87 ``spec_for_path``
and :185-203 ``shard_params``, which place the JAX parameters by path and
leave the collectives to GSPMD. Here the rules name the port's state-dict
tensors and the dimension each splits, in the port's layouts (HF Conv1D
(in, out): a column-parallel weight splits dim 1, a row-parallel one dim 0;
nn.Linear (out, in): the other way round):

- GPT-2 layers: ``c_attn`` column-parallel by heads (its packed [q | k |
  v] split head-aligned, each of q, k, v to rank m's heads m·H/tp ..),
  ``attn.c_proj`` row-parallel, ``c_fc`` column-, ``mlp.c_proj``
  row-parallel;
- the SA-Fuser blocks' MLP: fc1 column-, fc2 row-parallel (their
  attention stays whole, as JAX's rules leave it);
- the classifiers: column-parallel over the classes, the logits gathered
  before the losses.

A tensor whose dimension does not divide stays whole (JAX's rule), and so
does a whole layer whose heads, C or MLP width do not divide over tp
(``ops._common.shard_reason``), logged once: placement never changes the
numbers. The kernels take any local width, so a layer shards wherever JAX
shards its tensors; only a GPT-2 layer whose heads do not divide stays
whole here where JAX would still shard its MLP.
Each rank holds its shards (``shard_state``); ``canonical_state`` gathers
them back over the model group for a checkpoint, which stays the
one-process file. The layers run
``ops.fused_gpt2_train`` / ``ops.fused_block_train`` in their shard mode
(``ops._common.Shard``), given the model group's collectives
(``ModelComm``): the sums between the kernels are Megatron's f and g. The
LayerNorm affine gradients of a sharded layer are partial sums
(``TensorParallel.partial``), which the runner sums over the
model group. ``make_mesh_2d`` / ``make_mesh_3d`` make the grids.

Sequence parallelism (``SeqCtx``, afft_tpu/parallel/sharding.py:133-182):
the GPT-2 predictor's residual stream is T-sharded over the model group at
its layer boundaries; each layer gathers T on entry and reduce-scatters its
partial output over T.

ZeRO-1: the optimizer state sharded over the data-parallel processes.

Port of afft_tpu/parallel/sharding.py:87-130 ``shard_opt_state`` and its
wiring (afft_tpu/train/loop.py:372-384), ``train.zero_sharding=true``. The
JAX package places each state leaf's first divisible dimension over the data
axis and lets GSPMD derive the collectives; here they are explicit, over
flat buffers:

- the trainable parameters form buckets of whole tensors, at most
  ``mesh.GRAD_BUCKET`` elements each (the buckets of plain data
  parallelism); a bucket's flat vector is padded to a multiple of the
  process count R and cut into R equal slices, and process r owns slice r
  of every bucket. A parameter's piece is its part of the owned slice:
  contiguous, possibly empty;
- a step reduce-scatters each bucket's fp32 gradients (each process gets
  the sum of its slice), updates its pieces, holding only their optimizer
  state (``train.optim.Optimizer.shard``), and all-gathers the updated
  weights into every process's whole parameters;
- the gradient clip's global norm is the square root of the all-reduced
  square sums of the slices.

Per-element slicing and not JAX's per-leaf dimension: every parameter
shards, whatever its shape, each process holds 1/R of the state within one
bucket's padding, and the collectives are one per bucket. The update is
elementwise, so a piece takes the same update as the whole tensor would.
``gather`` assembles whole state tensors for a checkpoint, which is then the
one plain data parallelism or one process writes, and loads anywhere.

Under pipeline parallelism the processes that share the slicing are those of
one data group (the ranks of one stage, the runner's ``grid.data_group``),
each with its own parameter list: the layers its stage owns and the
replicated rest.
"""

from __future__ import annotations

import logging
import re
import warnings
from typing import Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import mesh
from ..ops._common import Shard

log = logging.getLogger(__name__)


class Zero1:
    """The slicing of ``params`` (contiguous tensors of one dtype, the
    optimizer's order) over the ranks of ``group`` (the world by default),
    this process's pieces."""

    def __init__(self, params, limit: int = mesh.GRAD_BUCKET, group=None):
        self.params = list(params)
        self.group = group
        self.rank, self.world = mesh.rank_and_world(group)
        index = {id(p): i for i, p in enumerate(self.params)}
        # per bucket: (parameter indices, their offsets, slice length)
        self.buckets = []
        # per parameter: (bucket, offset in the bucket, piece start and end
        # within the parameter, piece start within the owned slice)
        self.where = [None] * len(self.params)
        for b, bucket in enumerate(mesh.buckets(self.params, limit)):
            total = sum(p.numel() for p in bucket)
            size = -(-total // self.world)
            lo_own, hi_own = self.rank * size, (self.rank + 1) * size
            idx, offset = [], 0
            for p in bucket:
                i = index[id(p)]
                lo = min(max(offset, lo_own), offset + p.numel())
                hi = max(min(offset + p.numel(), hi_own), lo)
                self.where[i] = (b, offset, lo - offset, hi - offset,
                                 lo - lo_own if hi > lo else 0)
                idx.append(i)
                offset += p.numel()
            self.buckets.append((idx, size))

    def piece_view(self, i: int) -> torch.Tensor:
        """Parameter i's piece, a 1-D view of its storage."""
        _, _, lo, hi, _ = self.where[i]
        return self.params[i].detach().view(-1)[lo:hi]

    def piece(self, i: int, full: torch.Tensor) -> torch.Tensor:
        """This process's piece of ``full`` (parameter i's shape), a copy."""
        _, _, lo, hi, _ = self.where[i]
        return full.reshape(-1)[lo:hi].clone()

    def _flat(self, b, tensors, dtype, device):
        idx, size = self.buckets[b]
        flat = torch.zeros(size * self.world, dtype=dtype, device=device)
        for i in idx:
            if tensors[i] is not None:
                _, off, _, _, _ = self.where[i]
                flat[off:off + self.params[i].numel()] = \
                    tensors[i].reshape(-1)
        return flat

    def _local(self, b, pieces, dtype, device):
        idx, size = self.buckets[b]
        local = torch.zeros(size, dtype=dtype, device=device)
        for i in idx:
            if pieces[i] is not None and pieces[i].numel():
                _, _, _, _, at = self.where[i]
                local[at:at + pieces[i].numel()] = pieces[i]
        return local

    def reduce_scatter(self, grads) -> List[Optional[torch.Tensor]]:
        """The pieces of the gradients summed over the processes; ``grads``
        are fp32 and aligned with ``params`` (None where a parameter has no
        gradient, the same on every process). Returns the pieces (views of
        this process's slices), None where the gradient is None."""
        out: List[Optional[torch.Tensor]] = [None] * len(self.params)
        for b, (idx, _) in enumerate(self.buckets):
            if all(grads[i] is None for i in idx):
                continue
            dev = self.params[idx[0]].device
            mine = mesh.reduce_scatter_sum(
                self._flat(b, grads, torch.float32, dev), self.group)
            for i in idx:
                if grads[i] is not None:
                    _, _, lo, hi, at = self.where[i]
                    out[i] = mine[at:at + hi - lo]
        return out

    @torch.no_grad()
    def all_gather(self) -> None:
        """Every process's updated pieces into every process's parameters."""
        for b, (idx, _) in enumerate(self.buckets):
            p0 = self.params[idx[0]]
            pieces = [None] * len(self.params)
            for i in idx:
                pieces[i] = self.piece_view(i)
            full = mesh.all_gather_flat(self._local(b, pieces, p0.dtype,
                                                    p0.device), self.group)
            for i in idx:
                _, off, _, _, _ = self.where[i]
                p = self.params[i]
                p.detach().view(-1).copy_(full[off:off + p.numel()])

    def gather(self, pieces) -> List[Optional[torch.Tensor]]:
        """Whole tensors (each parameter's shape) from every process's
        ``pieces`` (aligned with ``params``; None where there is none, the
        same on every process). Every process must call it together."""
        out: List[Optional[torch.Tensor]] = [None] * len(self.params)
        for b, (idx, _) in enumerate(self.buckets):
            have = [i for i in idx if pieces[i] is not None]
            if not have:
                continue
            ref = pieces[have[0]]
            full = mesh.all_gather_flat(self._local(b, pieces, ref.dtype,
                                                    ref.device), self.group)
            for i in have:
                _, off, _, _, _ = self.where[i]
                p = self.params[i]
                out[i] = full[off:off + p.numel()].reshape(p.shape).clone()
        return out


# -- tensor parallelism -------------------------------------------------------

# (state-dict name regex, the dimension it splits): first match wins, the
# default is whole. "qkv": GPT-2's packed [q | k | v], split head-aligned.
TP_RULES = [
    # classifier heads: the class dimension of nn.Linear (classes, in)
    (r".*classifiers\..*\.weight$", 0),
    (r".*classifiers\..*\.bias$", 0),
    # GPT-2 MLP: column-parallel c_fc, row-parallel mlp.c_proj (Conv1D)
    (r".*gpt_model\.h\.\d+\.mlp\.c_fc\.weight$", 1),
    (r".*gpt_model\.h\.\d+\.mlp\.c_fc\.bias$", 0),
    (r".*gpt_model\.h\.\d+\.mlp\.c_proj\.weight$", 0),
    # GPT-2 attention: qkv column-parallel (heads split), proj row-parallel
    (r".*gpt_model\.h\.\d+\.attn\.c_attn\.weight$", "qkv1"),
    (r".*gpt_model\.h\.\d+\.attn\.c_attn\.bias$", "qkv0"),
    (r".*gpt_model\.h\.\d+\.attn\.c_proj\.weight$", 0),
    # fuser MLPs: column / row parallel (nn.Linear)
    (r".*blocks\.\d+\.mlp\.mlp\.0\.weight$", 0),
    (r".*blocks\.\d+\.mlp\.mlp\.0\.bias$", 0),
    (r".*blocks\.\d+\.mlp\.mlp\.2\.weight$", 1),
]


def spec_for_path(name: str, rules=TP_RULES):
    """The split of state-dict tensor ``name``: a dimension, "qkv1" /
    "qkv0" (the packed qkv's dimension 1 / 0, head-aligned), or None
    (whole)."""
    for pattern, spec in rules:
        if re.match(pattern, name):
            return spec
    return None


def _split_dim(spec):
    return int(spec[-1]) if isinstance(spec, str) else spec


def shard_tensor(full: torch.Tensor, spec, rank: int, count: int):
    """Model rank ``rank``'s shard of ``full`` under ``spec`` (a copy)."""
    dim = _split_dim(spec)
    if isinstance(spec, str):
        # [q | k | v]: rank m takes its columns of each of q, k and v
        shape = list(full.shape)
        view = full.reshape(shape[:dim] + [3, shape[dim] // 3]
                            + shape[dim + 1:])
        part = view.chunk(count, dim + 1)[rank]
        shape[dim] //= count
        return part.reshape(shape).clone()
    return full.chunk(count, dim)[rank].clone()


def unshard_tensor(parts, spec) -> torch.Tensor:
    """The whole tensor from every model rank's shard (in rank order)."""
    dim = _split_dim(spec)
    if isinstance(spec, str):
        shape = list(parts[0].shape)
        views = [p.reshape(shape[:dim] + [3, shape[dim] // 3]
                           + shape[dim + 1:]) for p in parts]
        shape[dim] *= len(parts)
        return torch.cat(views, dim + 1).reshape(shape)
    return torch.cat(list(parts), dim)


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, the gradient summed over the model
    group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return mesh.all_reduce_sum(g.contiguous(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the sum over the model group forward, identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        return mesh.all_reduce_sum(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromSeq(torch.autograd.Function):
    """Sequence parallelism's f: the T-shards all-gathered forward, the
    gradient's sum reduce-scattered over T backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return mesh.all_gather_dim(x.contiguous(), 1, group)

    @staticmethod
    def backward(ctx, g):
        return mesh.reduce_scatter_dim(g.contiguous(), 1, ctx.group), None


class _ScatterToSeq(torch.autograd.Function):
    """Sequence parallelism's g: the sum over the model group
    reduce-scattered over T forward, the gradient's T-shards all-gathered
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return mesh.reduce_scatter_dim(x.contiguous(), 1, group)

    @staticmethod
    def backward(ctx, g):
        return mesh.all_gather_dim(g.contiguous(), 1, ctx.group), None


class _SplitSeq(torch.autograd.Function):
    """A replicated (B, T, C) -> this rank's T-shard; backward the shards'
    gradients all-gathered (every rank's replicated upstream takes the
    whole gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        rank, world = mesh.rank_and_world(group)
        size = x.shape[1] // world
        return x.narrow(1, rank * size, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        return mesh.all_gather_dim(g.contiguous(), 1, ctx.group), None


class _JoinSeq(torch.autograd.Function):
    """The T-shards -> the replicated (B, T, C) by an all-gather; backward
    this rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.size = x.shape[1]
        return mesh.all_gather_dim(x.contiguous(), 1, group)

    @staticmethod
    def backward(ctx, g):
        rank, _ = mesh.rank_and_world(ctx.group)
        return g.narrow(1, rank * ctx.size, ctx.size).contiguous(), None


class _GatherLast(torch.autograd.Function):
    """The column-parallel classifier's logits: every rank's classes
    all-gathered on the last dimension forward, this rank's slice of the
    (replicated) gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.size = x.shape[-1]
        return mesh.all_gather_dim(x.contiguous(), x.dim() - 1, group)

    @staticmethod
    def backward(ctx, g):
        rank, _ = mesh.rank_and_world(ctx.group)
        return g.narrow(-1, rank * ctx.size, ctx.size).contiguous(), None


def copy_to_model(x, group):
    return _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    return _ReduceFromModel.apply(x, group)


def gather_from_seq(x, group):
    return _GatherFromSeq.apply(x, group)


def scatter_to_seq(x, group):
    return _ScatterToSeq.apply(x, group)


def split_seq(x, group):
    return _SplitSeq.apply(x, group)


def join_seq(x, group):
    return _JoinSeq.apply(x, group)


class ModelComm:
    """The collectives over one model group that the layers in the entries'
    shard mode (``ops.fused_block_train``, ``ops.fused_gpt2_train``) place
    between their launches, handed to them in their ``Shard``: the plain
    sum and the sequence dimension's gather and reduce-scatter for the
    kernels' autograd Function, and Megatron's differentiable f and g with
    their sequence-parallel forms for the plain versions."""

    def __init__(self, group):
        self.group = group

    def all_reduce(self, t):
        return mesh.all_reduce_sum(t, self.group)

    def gather_tokens(self, t):
        return mesh.all_gather_dim(t, 1, self.group)

    def scatter_tokens(self, t):
        return mesh.reduce_scatter_dim(t, 1, self.group)

    def f(self, x):
        return copy_to_model(x, self.group)

    def g(self, x):
        return reduce_from_model(x, self.group)

    def f_seq(self, x):
        return gather_from_seq(x, self.group)

    def g_seq(self, x):
        return scatter_to_seq(x, self.group)


class ColumnParallelLinear(nn.Linear):
    """A classifier's nn.Linear over this rank's classes (its weight and
    bias are the shards): the input through f (``copy_to_model``), the
    local logits all-gathered over the model group. A plain product, which
    the JAX package leaves to XLA: torch's."""

    def __init__(self, linear: nn.Linear, tp):
        nn.Module.__init__(self)
        self.in_features = linear.in_features
        self.out_features = linear.out_features
        self.weight, self.bias = linear.weight, linear.bias
        self.tp = tp

    def forward(self, x):
        group = self.tp.grid.model_group
        return _GatherLast.apply(F.linear(copy_to_model(x, group),
                                          self.weight, self.bias), group)


def make_mesh_2d(dp: int, tp: int, ranks=None) -> "mesh.Grid":
    """The (data, model) grid of ``ranks`` (the world by default): dp
    replicas of tp model ranks, the model axis innermost. Raises unless
    there are dp * tp processes. Every process of the world calls it
    together."""
    return make_mesh_3d(dp, tp, 1, ranks)


def make_mesh_3d(dp: int, tp: int, pp: int, ranks=None) -> "mesh.Grid":
    """The (data, pipe, model) grid (afft_tpu/parallel/sharding.py:58-67):
    dp replicas x pp GPipe stages x tp model ranks, rank (d · pp + s) · tp
    + m. Raises unless there are dp * tp * pp processes."""
    n = len(ranks) if ranks is not None else mesh.rank_and_world()[1]
    if dp * tp * pp != n:
        raise ValueError(f"a {dp} x {pp} x {tp} (data x pipe x model) grid "
                         f"needs {dp * tp * pp} processes, not {n}")
    if ranks is None and dp * pp * tp > 1:
        return mesh.grid(pp, tp)
    return mesh.Grid(pp, tp, ranks)


class TensorParallel:
    """One model's tensor-parallel placement over ``grid``'s model group:
    ``specs`` {state-dict name: split} of the tensors this rank holds a
    shard of, ``partial`` the names whose gradients the sharded layers leave
    as partial sums over the model group (their LayerNorms'); the sharded
    GPT-2 layers and fuser blocks are marked ``tp_sharded`` (which a deep
    copy of the model keeps). Shared, not copied, by a deep copy of the
    model (the runner's compute copy)."""

    def __init__(self, grid):
        self.grid = grid
        self.count, self.rank = grid.model_size, grid.model
        self.specs: Dict[str, object] = {}
        self.partial = set()
        self.comm = ModelComm(grid.model_group)

    def __deepcopy__(self, memo):
        return self

    def shard(self, sp: bool = False) -> Shard:
        return Shard(self.rank, self.count, self.comm, sp)

    @staticmethod
    def sharded(module) -> bool:
        return getattr(module, "tp_sharded", False)


_LOGGED = set()


def _log_once(msg: str) -> None:
    if msg not in _LOGGED:
        _LOGGED.add(msg)
        log.warning(msg)


def plan_model(model: nn.Module, tp: TensorParallel) -> None:
    """Fill ``tp``'s placement for ``model`` (whole tensors, before any is
    sharded) and mark the layers it shards: every layer that a module's
    ``tp_blocks`` offers (the GPT-2 predictor's layers, the SA-Fuser's
    blocks) with no reason to stay whole, and every classifier whose
    classes divide; the rest stays whole, each reason logged once."""
    count = tp.count
    names = {id(p): n for n, p in model.named_parameters()}
    for prefix, module in model.named_modules():
        if hasattr(module, "tp_blocks"):
            for i, blk, why, partial in module.tp_blocks(count):
                if why is not None:
                    _log_once(f"tensor parallelism: {prefix} layer {i} stays "
                              f"whole: {why}")
                    continue
                blk.tp_sharded = True
                for n, p in blk.named_parameters():
                    full = names[id(p)]
                    spec = spec_for_path(full)
                    if spec is not None:
                        tp.specs[full] = spec
                    elif n.startswith(partial):
                        tp.partial.add(full)
        elif prefix.rsplit(".", 1)[-1] == "classifiers":
            for n, p in module.named_parameters():
                full = names[id(p)]
                if p.shape[0] % count == 0:
                    tp.specs[full] = spec_for_path(full)
                else:
                    _log_once(f"tensor parallelism: {full} stays whole: "
                              f"{p.shape[0]} classes do not divide over tp "
                              f"= {count}")
    # a module registered under several names (a shared classifier) has
    # its tensors under each of them in the state dict
    split = {id(p): tp.specs[n] for n, p in model.named_parameters()
             if n in tp.specs}
    for k, v in model.state_dict(keep_vars=True).items():
        if id(v) in split:
            tp.specs[k] = split[id(v)]


@torch.no_grad()
def tensor_parallel(model: nn.Module, grid, seq_parallel: bool = False):
    """Shard ``model`` (whole, its weights drawn or loaded) over ``grid``'s
    model group in place: each planned parameter keeps rank
    ``grid.model``'s shard, the sharded layers run in the kernels' shard
    mode, the sharded classifiers gather their logits; with
    ``seq_parallel`` the GPT-2 predictors get a ``SeqCtx``. Returns the
    ``TensorParallel``."""
    tp = TensorParallel(grid)
    plan_model(model, tp)
    for name, p in model.named_parameters():
        if name in tp.specs:
            p.data = shard_tensor(p.data, tp.specs[name], tp.rank, tp.count)
    names = {id(p): n for n, p in model.named_parameters()}
    for module in list(model.modules()):
        if hasattr(module, "tensor_parallel"):
            module.tensor_parallel = tp
        if seq_parallel and hasattr(module, "seq_ctx"):
            module.seq_ctx = SeqCtx(grid)
        if isinstance(module, nn.Sequential) and len(module) == 2 \
                and type(module[1]) is nn.Linear \
                and names.get(id(module[1].weight)) in tp.specs:
            # a classifier (shared ones are one module under every head)
            module[1] = ColumnParallelLinear(module[1], tp)
    return tp


def shard_state(tp: TensorParallel, state: Dict) -> Dict:
    """This rank's tensors of a whole (canonical) state dict: the shards of
    the planned ones, the rest as they are."""
    return {k: shard_tensor(v, tp.specs[k], tp.rank, tp.count)
            if k in tp.specs else v for k, v in state.items()}


def canonical_state(tp: TensorParallel, local: Dict) -> Dict:
    """The whole state dict from every model rank's ``local`` one (its
    shards gathered over the model group; every rank of the group calls it
    together and gets the whole tensors)."""
    out = {}
    for k, v in local.items():
        spec = tp.specs.get(k)
        if spec is None:
            out[k] = v
            continue
        parts = mesh.all_gather_cat(v.detach().contiguous()[None],
                                    tp.grid.model_group)
        out[k] = unshard_tensor(list(parts), spec)
    return out


class SeqCtx:
    """Megatron-style sequence parallelism over ``grid``'s model group
    (afft_tpu/parallel/sharding.py:133-182), set on a GPT-2 predictor
    (``predictor.seq_ctx``) whose layers are tensor-parallel: the residual
    stream (B, T, C) is this rank's T-shard between the layers; each layer
    gathers T on entry and reduce-scatters its partial output over T. When
    T does not divide over the model ranks the stream stays whole (the
    layers tensor-parallel alone), with one warning."""

    def __init__(self, grid):
        if grid.model_size < 2:
            raise ValueError("sequence parallelism needs a model axis of 2 "
                             "or more ranks (make_mesh_2d(dp, tp))")
        self.grid = grid
        self.group, self.size = grid.model_group, grid.model_size
        self._warned = False

    def __deepcopy__(self, memo):
        return self

    def applies(self, T: int) -> bool:
        """Whether a stream of T tokens is T-sharded (warns once if not)."""
        if T % self.size == 0:
            return True
        if not self._warned:
            self._warned = True
            warnings.warn(
                f"sequence parallelism disabled for this stack: T={T} does "
                f"not divide over model={self.size}; activations stay "
                f"replicated over the model axis", stacklevel=2)
        return False
