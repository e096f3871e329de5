"""ZeRO-1: the optimizer state sharded over the data-parallel processes.

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

from typing import List, Optional

import torch

from . import mesh


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
