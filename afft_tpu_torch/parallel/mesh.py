"""Process group, device choice and the collectives of data parallelism.

Port of afft_tpu/parallel/mesh.py. The JAX package runs one process per
host over a device mesh; the port runs one process per card, as the
reference does (torchrun, an NCCL process group, DistributedSampler-style
shards; reference run.py:42-44, common/utils.py:148-192):

- ``init_distributed`` reads the torchrun environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) or a
  multi-task SLURM step (``_slurm_rendezvous``) and joins the process group:
  NCCL on CUDA, gloo on the CPU, and gloo where several ranks share one card
  (an explicit ``cuda:K``: NCCL refuses two ranks on one device). Ranks other
  than 0 log errors only.
- ``--device cuda`` gives each rank ``cuda:LOCAL_RANK``; an explicit index
  pins every rank to that card.
- The collectives below act on tensors where they lie, over the world or
  over the ``group`` they are given. Over gloo a CUDA tensor goes through a
  host copy (gloo's CUDA support differs by op), bf16 and bool are gathered
  as their bytes. Without a process group each is the identity, so one
  process runs the same code. A collective that fails raises: nothing here
  falls back to a local result.
- Pipeline parallelism (``train.pipeline_stages`` = S > 1) lays the R
  processes out as a grid (``grid``, the counterpart of
  afft_tpu/parallel/pipeline.py:252-262 ``make_mesh_data_pipe``): rank r is
  data replica r // S and stage r % S. The data group (the ranks of one
  stage) carries what data parallelism carries; the pipe group (the ranks
  of one replica) carries the activations between stages (``send`` /
  ``recv``, ``broadcast``). The runner holds its grid (``grid``) and
  passes its data group to every reduction it makes; without pipelining
  the data group is the world.
- Tensor parallelism adds a model axis, innermost (the counterpart of
  afft_tpu/parallel/sharding.py:49-67 ``make_mesh_2d`` / ``make_mesh_3d``,
  which reshape the devices to (data, pipe, model)): rank r = (d · S + s) ·
  tp + m. The model group (the tp ranks of one replica's stage) carries the
  partial sums of the sharded layers (``parallel.sharding``). A grid may
  cover some of the processes only (``ranks``), so that several layouts run
  in one set of processes.
"""

from __future__ import annotations

import logging
import os
import re
import subprocess
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

# elements of fp32 gradient that one collective moves (256 MB): the
# buckets of data parallelism and of ZeRO-1
GRAD_BUCKET = 1 << 26

# the process group's own timeout: a rank that dies mid-collective fails
# the others within this time instead of hanging them
TIMEOUT = timedelta(minutes=30)


def _slurm_rendezvous():
    """SLURM-launched rendezvous (reference common/utils.py:157-172), as
    afft_tpu/parallel/mesh.py:24-56: (coordinator "host:port", tasks, task
    id) under a multi-task SLURM step without explicit coordinator variables,
    else None. The coordinator is task 0's node on a port derived from the
    job id, so concurrent jobs on a shared node do not collide."""
    if "SLURM_PROCID" not in os.environ or "SLURM_NTASKS" not in os.environ:
        return None
    ntasks = int(os.environ["SLURM_NTASKS"])
    if ntasks <= 1:
        return None
    nodelist = os.environ.get("SLURM_STEP_NODELIST",
                              os.environ.get("SLURM_JOB_NODELIST", ""))
    # expand "prefix[a-b,c],other" -> first hostname; scontrol is the
    # canonical expander but may be absent inside containers
    try:
        first = subprocess.run(
            ["scontrol", "show", "hostnames", nodelist],
            capture_output=True, text=True, timeout=10,
        ).stdout.split()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        m = re.match(r"([^\[,]+)(?:\[([^\]\-,]+))?", nodelist)
        if not m or not m.group(1):
            return None
        first = m.group(1) + (m.group(2) or "")
    port = 12300 + int(os.environ.get("SLURM_JOB_ID", "0")) % 20000
    return (f"{first}:{port}", ntasks, int(os.environ["SLURM_PROCID"]))


def rank_device(device, local_rank: int) -> torch.device:
    """This rank's device: ``cuda`` is ``cuda:LOCAL_RANK``, ``cuda:K`` pins
    every rank to card K, ``cpu`` is the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", local_rank)
    return dev


def init_distributed(device="cuda", logger=None) -> dict:
    """Join the process group the launcher describes, if any; returns
    {"rank", "world_size", "local_rank", "distributed", "device",
    "backend"}. ``distributed`` is whether a process group exists (torchrun
    with one process makes one too). ``device`` is a resolved device
    string or torch.device; see ``rank_device``."""
    env = os.environ
    rank, world, local_rank, init = 0, 1, 0, None
    if int(env.get("WORLD_SIZE") or 1) > 1 and "MASTER_ADDR" not in env:
        raise RuntimeError(
            f"WORLD_SIZE={env['WORLD_SIZE']} without MASTER_ADDR / "
            "MASTER_PORT: start the processes through torchrun (python -m "
            "afft_tpu_torch.run -n N)")
    if "WORLD_SIZE" in env and "MASTER_ADDR" in env:
        rank, world = int(env.get("RANK", 0)), int(env["WORLD_SIZE"])
        local_rank = int(env.get("LOCAL_RANK", 0))
        init = "env://"
    else:
        slurm = _slurm_rendezvous()
        if slurm is not None:
            coordinator, world, rank = slurm
            local_rank = int(env.get("SLURM_LOCALID", 0))
            init = f"tcp://{coordinator}"
    dev = rank_device(device, local_rank)
    backend = None
    if init is not None and not dist.is_initialized():
        local_world = int(env.get("LOCAL_WORLD_SIZE",
                                  env.get("SLURM_NTASKS_PER_NODE", 1)))
        pinned = torch.device(device).index is not None
        shared = dev.type == "cuda" and pinned and local_world > 1
        backend = "nccl" if dev.type == "cuda" and not shared else "gloo"
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init, world_size=world,
                                rank=rank, timeout=TIMEOUT)
        if shared:
            logging.getLogger(__name__).info(
                "%d ranks share %s: gloo process group", local_world, dev)
    elif dist.is_initialized():
        backend = dist.get_backend()
        rank, world = dist.get_rank(), dist.get_world_size()
    info = {"rank": rank, "world_size": world, "local_rank": local_rank,
            "distributed": dist.is_initialized(), "device": dev,
            "backend": backend}
    if world > 1 and rank != 0:
        # non-master processes log errors only
        # (reference utils.setup_for_distributed, common/utils.py:97-116)
        logging.getLogger().setLevel(logging.ERROR)
    if logger is not None:
        logger.info("process %d of %d on %s (%s)", rank, world, dev,
                    backend or "no process group")
    return info


def active() -> bool:
    """Whether a process group exists (the collectives below act)."""
    return dist.is_available() and dist.is_initialized()


def rank_and_world(group=None):
    """(this process's rank, the process count) in ``group`` (the world by
    default); (0, 1) without a process group."""
    if not active():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


class Grid:
    """The data x pipe x model layout of the processes ``ranks`` (the world
    by default) for S = ``stages`` stages and tp = ``model`` model ranks:
    the i-th of them is data replica ``data`` = i // (S · tp) of
    ``replicas``, stage ``stage`` = (i // tp) % S and model rank ``model`` =
    i % tp. ``data_group`` holds the ranks of this (stage, model rank),
    ``pipe_group`` those of this (replica, model rank) (``pipe_ranks``, in
    stage order, global ranks), ``model_group`` those of this (replica,
    stage). On the world with one stage and one model rank every rank is a
    replica and the data group is the world (None); a group of one rank is
    None too where the grid covers the world. A process outside ``ranks``
    (``member`` false) takes part in making the groups and nothing else."""

    def __init__(self, stages: int, model: int = 1, ranks=None):
        rank, world = rank_and_world()
        whole = ranks is None
        ranks = list(range(world)) if whole else [int(r) for r in ranks]
        n = len(ranks)
        if stages < 1 or model < 1 or n % (stages * model):
            what = f"train.pipeline_stages={stages}" + (
                f" x model={model}" if model != 1 else "")
            raise ValueError(f"{what} must divide the process count {n}")
        self.stages, self.model_size = stages, model
        self.replicas = n // (stages * model)
        self.ranks, self.member = ranks, rank in ranks
        i = ranks.index(rank) if self.member else 0
        self.data, rest = divmod(i, stages * model)
        self.stage, self.model = divmod(rest, model)

        def at(d, s, m):
            return ranks[(d * stages + s) * model + m]
        self.pipe_ranks = [at(self.data, s, self.model)
                           for s in range(stages)]
        self.data_group = self.pipe_group = self.model_group = None
        if world > 1 and (stages > 1 or model > 1 or not whole):
            # every rank creates every group, in one order
            data = {(s, m): dist.new_group([at(d, s, m)
                                            for d in range(self.replicas)])
                    for s in range(stages) for m in range(model)}
            self.data_group = data[self.stage, self.model]
            if stages > 1:
                pipe = {(d, m): dist.new_group([at(d, s, m)
                                                for s in range(stages)])
                        for d in range(self.replicas) for m in range(model)}
                self.pipe_group = pipe[self.data, self.model]
            if model > 1:
                groups = {(d, s): dist.new_group([at(d, s, m)
                                                  for m in range(model)])
                          for d in range(self.replicas)
                          for s in range(stages)}
                self.model_group = groups[self.data, self.stage]


# (stages, model) -> Grid: a process makes each grid's groups once
_GRIDS = {}


def grid(stages: int, model: int = 1) -> Grid:
    """The grid of the world over ``stages`` stages (0 and 1: no
    pipelining) and ``model`` model ranks. The groups of a grid are made on
    its first use, by every rank together, and kept for the process."""
    stages = max(int(stages), 1)
    if stages == 1 and model == 1:
        return Grid(1)
    if (stages, model) not in _GRIDS:
        _GRIDS[stages, model] = Grid(stages, model)
    return _GRIDS[stages, model]


def _alone(group) -> bool:
    """Whether a collective over ``group`` has nothing to do: no process
    group, or a group of one rank (a data group of one replica)."""
    return not active() or (group is not None
                            and dist.get_world_size(group) == 1)


def _comm_device(t: torch.Tensor) -> torch.device:
    """Where a collective on ``t`` runs: NCCL on the card (the current one
    for a host tensor), gloo on the host."""
    if dist.get_backend() != "nccl":
        return torch.device("cpu")
    return t.device if t.is_cuda else torch.device(
        "cuda", torch.cuda.current_device())


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise sum of ``t`` over the ranks of ``group``, on t's
    device (t is not changed)."""
    if _alone(group):
        return t
    buf = t.detach().to(_comm_device(t), copy=True)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.device)


def all_reduce_sum_(tensors, group=None) -> None:
    """Sum each tensor of ``tensors`` over the ranks of ``group``, in
    place."""
    if _alone(group):
        return
    for t in tensors:
        dev = _comm_device(t)
        if dev == t.device:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        else:
            buf = t.to(dev)
            dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
            t.copy_(buf)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t`` as gloo moves it whatever its dtype: bool as uint8, bf16 and
    fp16 as their bytes (the last dim doubles)."""
    src = t.detach().contiguous()
    if src.dtype == torch.bool:
        return src.to(torch.uint8)
    if src.dtype in (torch.bfloat16, torch.float16):
        return src.view(torch.uint8)
    return src


def _from_bytes(buf: torch.Tensor, dtype) -> torch.Tensor:
    return buf.bool() if dtype == torch.bool else buf.view(dtype)


def all_gather_cat(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated on dim 0 in the rank
    order of ``group``, on t's device. bf16 and fp16 travel as their bytes,
    bool as uint8."""
    if _alone(group):
        return t
    _, world = rank_and_world(group)
    src = _as_bytes(t).to(_comm_device(t))
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src, group=group)
    return _from_bytes(torch.cat(parts).to(t.device), t.dtype)


def all_gather_dim(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in the
    rank order of ``group`` (sequence parallelism's all-gather over T)."""
    if _alone(group):
        return t
    moved = t.movedim(dim, 0).contiguous()
    return all_gather_cat(moved, group).movedim(0, dim)


def reduce_scatter_dim(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """This rank's slice along ``dim`` (its length a multiple of the
    group's size) of the elementwise sum of ``t`` over ``group``, through
    ``reduce_scatter_sum`` (sequence parallelism's reduce-scatter over
    T)."""
    if _alone(group):
        return t
    _, world = rank_and_world(group)
    moved = t.movedim(dim, 0).contiguous()
    part = reduce_scatter_sum(moved.flatten(), group)
    return part.view(moved.shape[0] // world,
                     *moved.shape[1:]).movedim(0, dim).contiguous()


def reduce_scatter_sum(flat: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's slice of the elementwise sum of ``flat`` (1-D, its length
    a multiple of the group's size) over the ranks of ``group``: NCCL's
    reduce-scatter; gloo has none, so an all-reduce and the rank's slice,
    the same numbers. Without a process group, ``flat``."""
    if _alone(group):
        return flat
    rank, world = rank_and_world(group)
    size = flat.numel() // world
    if dist.get_backend() == "nccl" and flat.is_cuda:
        out = torch.empty(size, dtype=flat.dtype, device=flat.device)
        dist.reduce_scatter_tensor(out, flat.contiguous(), group=group)
        return out
    return all_reduce_sum(flat, group)[rank * size:(rank + 1) * size]


def all_gather_flat(local: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``local`` (1-D, equal lengths) concatenated in the rank
    order of ``group``: NCCL's all-gather into one tensor, else
    ``all_gather_cat``."""
    if _alone(group):
        return local
    if dist.get_backend() == "nccl" and local.is_cuda:
        _, world = rank_and_world(group)
        out = torch.empty(local.numel() * world, dtype=local.dtype,
                          device=local.device)
        dist.all_gather_into_tensor(out, local.contiguous(), group=group)
        return out
    return all_gather_cat(local, group)


def send(t: torch.Tensor, dst: int) -> None:
    """``t`` to rank ``dst`` (a global rank), which ``recv``s it: NCCL's
    send of a CUDA tensor, else through a host copy (gloo has no CUDA
    point-to-point), bf16 as its bytes."""
    dev = _comm_device(t)
    dist.send(_as_bytes(t).to(dev), dst)


def recv(shape, dtype, device, src: int) -> torch.Tensor:
    """The tensor of ``shape`` and ``dtype`` that rank ``src`` ``send``s,
    on ``device``."""
    like = torch.empty(shape, dtype=dtype, device=device)
    buf = torch.empty_like(_as_bytes(like), device=_comm_device(like))
    dist.recv(buf, src)
    return _from_bytes(buf.to(device), dtype)


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Rank ``src``'s (a global rank) ``t`` on every rank of ``group``, on
    t's device: every rank passes a tensor of the shape and dtype that
    ``src`` holds; the others' values are not read."""
    if _alone(group):
        return t
    buf = _as_bytes(t).to(_comm_device(t), copy=True)
    dist.broadcast(buf, src, group=group)
    return _from_bytes(buf.to(t.device), t.dtype)


def buckets(tensors, limit: int):
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


def barrier() -> None:
    if active():
        dist.barrier()


def gather_from_all(array, group=None) -> np.ndarray:
    """Every rank's array (equal rank, first dimensions may differ)
    concatenated on axis 0 in the rank order of ``group``, on every rank of
    it (reference utils.gather_from_all, common/utils.py:207-232)."""
    array = np.ascontiguousarray(array)
    if not active():
        return array
    t = torch.from_numpy(array)
    sizes = all_gather_cat(torch.tensor([t.shape[0]]), group).tolist()
    pad = max(sizes) - t.shape[0]
    if pad:
        t = torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])
    parts = all_gather_cat(t, group).numpy()
    rows = max(sizes)
    return np.concatenate([parts[r * rows:r * rows + k]
                           for r, k in enumerate(sizes)], axis=0)


def any_rank(flag: bool, group=None) -> bool:
    """Whether ``flag`` is set on any rank of ``group`` (one decision for
    all of them)."""
    if not active():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int64)
    return bool(all_reduce_sum(t, group).item() > 0)


def shutdown() -> None:
    _GRIDS.clear()
    if active():
        dist.destroy_process_group()
