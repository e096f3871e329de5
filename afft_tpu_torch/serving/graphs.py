"""One CUDA graph per batch bucket over a ``Server``'s serving function.

The port's counterpart of the JAX package's per-bucket ``jax.export``
executables (tools/export_serving.py:105-191): a bucket is a fixed batch
size, and its graph replays the whole served forward (int8 dequantization,
``BaseModel``, ``head_logits``, top-k or the dense logits) as one launch
from the host, where the eager forward makes one launch per kernel and per
PyTorch op.

``GraphServer`` captures, for each bucket B (the largest first, so that
the smaller captures reuse its memory): static inputs (the serving dtype's
features, or int8 features plus fp32 (B, T) scales); a warm-up on a side
stream, which also builds the kernels (``ops._build``) before any capture;
then ``torch.cuda.CUDAGraph`` of the serving function into one memory pool
that every bucket shares, keeping the static outputs. ``run`` copies a
batch into the static inputs, replays on ``stream`` and returns the static
outputs. A later replay of any bucket may overwrite them (the buckets share
the pool), so the caller copies them out on ``stream`` before the next
``run``. It runs on CUDA only: the CPU path is the eager ``Server``
(``EagerBucketServer``). A failed capture or replay raises; there is no
eager fallback on the card.

What the captured forward must keep (every kernel wrapper of ``ops`` does):
- launch on ``torch.cuda.current_stream`` (``ops._common.launch``), which is
  the capture stream inside ``torch.cuda.graph``;
- allocate outputs and scratch through PyTorch, so that they come from the
  graph's pool and keep their addresses at replay; the GEMMs' TMA
  descriptors are encoded on the host at capture and point at those
  buffers (``csrc/gemm_sm90.cuh``);
- no host sync, ``.item()`` or copy from pageable host memory in the
  forward: the masks are built on the device (``models/layers.py``);
- per-launch ``cudaFuncSetAttribute`` is legal under capture; the TMA
  descriptor encoder (``cuTensorMapEncodeTiled``) is looked up in the
  warm-up;
- the launch counters (``ops.launch_counts``) count Python calls, so they
  see a kernel at capture and never at replay: ``capture_launches`` holds
  each bucket's counts taken during its capture.
"""

from __future__ import annotations

import contextlib
import time

import torch

from ..ops import launch_counts

WARMUP_CALLS = 2


class _Buckets:
    """What both bucket servers share: the serving function and the input
    contract of each bucket."""

    def __init__(self, server, buckets, *, input_dtype="native", topk=0):
        self.server = server
        self.buckets = sorted({int(b) for b in buckets})
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets {buckets}: positive batch sizes")
        self.input_dtype, self.topk = input_dtype, int(topk)
        self.int8 = input_dtype == "int8"
        self.fn = server.serving_fn(input_dtype, topk)
        self.device = server.device
        self.n_frames, self.modal_dims = server.n_frames, server.modal_dims
        self.feat_dtype = torch.int8 if self.int8 else server.dtype

    def check(self, bucket, feats, scales=None):
        """Raise ValueError unless ``bucket`` is one of the buckets and
        ``feats`` ({mod: (bucket, T, F)}) and, for int8 input, ``scales``
        ({mod: (bucket, T)}) fit it."""
        if bucket not in self.buckets:
            raise ValueError(f"bucket {bucket}: the buckets are "
                             f"{self.buckets}")
        if self.int8 != (scales is not None):
            raise ValueError("int8 input takes scales, native input none")
        for part in (feats, scales) if self.int8 else (feats,):
            if set(part) != set(self.modal_dims):
                raise ValueError(f"modalities {sorted(part)}, the bundle "
                                 f"serves {sorted(self.modal_dims)}")
        for m, d in self.modal_dims.items():
            if tuple(feats[m].shape) != (bucket, self.n_frames, d):
                raise ValueError(f"{m}: features {tuple(feats[m].shape)}, "
                                 f"bucket {bucket} takes "
                                 f"{(bucket, self.n_frames, d)}")
            if self.int8 and tuple(scales[m].shape) != (bucket,
                                                        self.n_frames):
                raise ValueError(f"{m}: scales {tuple(scales[m].shape)}, "
                                 f"bucket {bucket} takes "
                                 f"{(bucket, self.n_frames)}")

    def zero_inputs(self, bucket, device=None, pin=False):
        """Zero inputs of a bucket: (feats,) or (feats, scales)."""
        kw = dict(device=device or self.device, pin_memory=pin)
        feats = {m: torch.zeros((bucket, self.n_frames, d),
                                dtype=self.feat_dtype, **kw)
                 for m, d in self.modal_dims.items()}
        if not self.int8:
            return (feats,)
        return feats, {m: torch.ones((bucket, self.n_frames),
                                     dtype=torch.float32, **kw)
                       for m in self.modal_dims}

    def stream_context(self):
        return contextlib.nullcontext()


class EagerBucketServer(_Buckets):
    """The bucket contract without graphs: each ``run`` is one eager forward
    at the bucket's padded shape. The concurrent server's path on the CPU;
    on the card, the graphs' yardstick."""

    stream = None

    def run(self, bucket, feats, scales=None):
        self.check(bucket, feats, scales)
        args = ({m: x.to(self.device) for m, x in feats.items()},)
        if self.int8:
            args += ({m: x.to(self.device) for m, x in scales.items()},)
        return self.fn(*args)


class GraphServer(_Buckets):
    """One captured CUDA graph per batch bucket (see the module docstring).
    ``capture_s``, ``pool_bytes`` and ``capture_launches`` hold each
    bucket's capture seconds, the memory pool's growth during its capture
    and the kernel launches counted during its capture."""

    def __init__(self, server, buckets, *, input_dtype="native", topk=0,
                 log=None):
        if server.device.type != "cuda":
            raise ValueError(
                f"GraphServer captures CUDA graphs; the server is on "
                f"{server.device} (serve the CPU through Server or "
                "EagerBucketServer)")
        super().__init__(server, buckets, input_dtype=input_dtype, topk=topk)
        self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs, self.inputs, self.outputs = {}, {}, {}
        self.capture_s, self.pool_bytes, self.capture_launches = {}, {}, {}
        for b in reversed(self.buckets):
            self._capture(b)
            if log is not None:
                log(f"graph bucket {b}: captured in {self.capture_s[b]:.3f} "
                    f"s, pool +{self.pool_bytes[b]} bytes, launches "
                    f"{self.capture_launches[b]}")

    def _capture(self, bucket):
        dev = self.device
        args = self.zero_inputs(bucket)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                self.fn(*args)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        # torch.cuda.graph empties the allocator's cache as it starts: do
        # so first, so that the growth measured is the pool's alone
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        reserved = torch.cuda.memory_reserved(dev)
        before = launch_counts()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            out = self.fn(*args)
        torch.cuda.synchronize(dev)
        self.capture_s[bucket] = time.perf_counter() - t0
        self.pool_bytes[bucket] = torch.cuda.memory_reserved(dev) - reserved
        self.capture_launches[bucket] = {
            k: n - before.get(k, 0) for k, n in launch_counts().items()
            if n != before.get(k, 0)}
        self.graphs[bucket], self.inputs[bucket] = graph, args
        self.outputs[bucket] = out

    def stream_context(self):
        return torch.cuda.stream(self.stream)

    def replay(self, bucket):
        """Replay a bucket's graph on ``stream`` over its static inputs as
        they stand; returns the static outputs."""
        with torch.cuda.stream(self.stream):
            self.graphs[bucket].replay()
        return self.outputs[bucket]

    def run(self, bucket, feats, scales=None):
        """Copy a batch ({mod: (bucket, T, F)} features, pinned host memory
        for an asynchronous copy, and for int8 the scales) into the bucket's
        static inputs and replay, all on ``stream``; returns the static
        outputs (fp32 logits, or (values, indices)), valid until the next
        ``run``."""
        self.check(bucket, feats, scales)
        static = self.inputs[bucket]
        with torch.cuda.stream(self.stream):
            for m, x in feats.items():
                static[0][m].copy_(x, non_blocking=True)
            if self.int8:
                for m, x in scales.items():
                    static[1][m].copy_(x, non_blocking=True)
            return self.replay(bucket)
