"""Concurrent serving: dynamic batching over a bundle's batch buckets.

The port's counterpart of tools/serve_concurrent.py. Each bucket of a
bundle (``tools.export_serving --batch 8,64,256``) is a fixed batch size,
served on the card by its captured CUDA graph (``serving.graphs``), so
dynamic batching means: coalesce single-clip requests as they arrive, pick
the smallest bucket that holds them, pad the rest with zeros.

``BundleServer``:
- ``submit(clip)`` takes one clip ({mod: (T, F)} floats) and returns a
  Future of (the clip's fp32 logits, or (values, indices) of a top-k
  bundle; seconds from submit to result);
- a scheduler thread coalesces requests until the largest bucket fills or
  ``max_wait_ms`` passes with an empty queue, assembles the padded batch on
  the host (for an int8 bundle quantized per frame with the port's copy of
  ``PackedFeatureStore._quantize_rows``: one byte a feature and one fp32
  scale a frame over the link), copies it into a pinned staging slot of
  its bucket and replays the bucket's graph, then enqueues the outputs'
  copy into the slot's pinned host buffers and a CUDA event, all on the
  graph server's stream, and moves on;
- a completer thread waits on each dispatch's event (not on the whole
  device) and fulfils its futures;
- at most ``max_inflight`` dispatches are in flight (a semaphore). Each
  bucket has ``max_inflight`` slots used in turn: a slot comes round again
  only after its dispatch has completed, and the outputs' copy follows its
  replay on one stream before any later replay, so no static output and
  no staging buffer is overwritten before it is read;
- a malformed request (a missing modality, a wrong shape) fails its
  batch's futures and not the scheduler;
- ``take_host_times()`` gives the host seconds each thread spent in each
  stage since the last take: the scheduler's ``assemble`` (padding),
  ``quantize``, ``slot_wait`` (the in-flight semaphore), ``stage`` (the
  copy into the pinned slot) and ``replay`` (the copies, the replay and
  the outputs' copy, enqueued), and the completer's ``device_wait`` and
  ``complete``.

On ``--device cpu`` the buckets run eagerly through ``Server`` at the same
padded shapes (the tests use this).

Usage:
  python -m afft_tpu_torch.tools.export_serving \\
      -c expts/01_SA-Fuser_ek100_val_Swin.txt --batch 8,64,256 --out DIR
  python -m afft_tpu_torch.tools.serve_concurrent --bundle DIR \\
      --rate 2000 --duration 20        # open loop: latency percentiles
  python -m afft_tpu_torch.tools.serve_concurrent --bundle DIR \\
      --closed 64 --duration 20        # closed loop: saturated clips/s
  python -m afft_tpu_torch.tools.serve_concurrent --bundle DIR --sweep \\
      --duration 5 [--out results.jsonl]
``--sweep`` runs a closed loop at 2 x the largest bucket of clients, then
open loops at 0.25, 0.5 and 0.75 of its rate; each result is one JSON
line, appended to ``--out`` too.
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from ..data.readers import PackedFeatureStore
from .serve_bundle import load_bundle_buckets

HOST_STAGES = ("assemble", "quantize", "slot_wait", "stage", "replay",
               "device_wait", "complete")


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


class BundleServer:
    """Dynamic-batching server over a bundle's buckets (module docstring).
    Thread-safe; ``close()`` drains and stops."""

    def __init__(self, bundle_dir, max_wait_ms=2.0, max_inflight=2,
                 device="cuda", log=print):
        self.runner, self.meta = load_bundle_buckets(bundle_dir, device,
                                                     log=log)
        self.buckets = self.runner.buckets
        self.max_wait_s = max_wait_ms / 1e3
        self._cuda = self.runner.device.type == "cuda"
        self._int8 = self.runner.int8
        self._queue = queue.SimpleQueue()  # (clip, Future, t_submit)
        self._done_q = queue.Queue()       # (event, outputs, requests)
        self._inflight = threading.Semaphore(max_inflight)
        self._stop = threading.Event()
        self._slots = {b: [self._slot(b) for _ in range(max_inflight)]
                       for b in self.buckets}
        self._turn = dict.fromkeys(self.buckets, 0)
        self.batch_hist = dict.fromkeys(self.buckets, 0)  # dispatches
        self.host_s = dict.fromkeys(HOST_STAGES, 0.0)
        self._host_t0 = time.perf_counter()
        for b in self.buckets:  # every bucket once before the first request
            with self.runner.stream_context():
                self.runner.run(b, *self._slots[b][0]["in"])
        if self._cuda:
            torch.cuda.synchronize(self.runner.device)
        self._sched = threading.Thread(target=self._scheduler, daemon=True)
        self._compl = threading.Thread(target=self._completer, daemon=True)
        self._sched.start()
        self._compl.start()

    # ---- client API ----

    def submit(self, clip):
        fut = Future()
        self._queue.put((clip, fut, time.perf_counter()))
        return fut

    def take_host_times(self):
        """{stage: host seconds since the last take} (module docstring),
        and ``wall_s``, the seconds since the last take; starts anew."""
        now = time.perf_counter()
        out = dict(self.host_s, wall_s=now - self._host_t0)
        self.host_s = dict.fromkeys(HOST_STAGES, 0.0)
        self._host_t0 = now
        return out

    def close(self):
        self._stop.set()
        self._sched.join(timeout=60)
        self._done_q.put(None)
        self._compl.join(timeout=60)

    # ---- internals ----

    def _slot(self, bucket):
        """A bucket's staging inputs (pinned on the card) and, on the card,
        pinned host outputs and the event of the dispatch that fills
        them."""
        slot = {"in": self.runner.zero_inputs(bucket, device="cpu",
                                              pin=self._cuda)}
        if self._cuda:
            slot["out"] = tuple(
                torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                for o in _as_tuple(self.runner.outputs[bucket]))
            slot["event"] = torch.cuda.Event()
        return slot

    def _collect(self):
        """Block for the first request, then drain until the largest bucket
        fills or ``max_wait_ms`` passes with an empty queue."""
        try:
            first = self._queue.get(timeout=0.05)
        except queue.Empty:
            return None
        reqs = [first]
        cap = self.buckets[-1]
        deadline = time.perf_counter() + self.max_wait_s
        while len(reqs) < cap:
            try:
                reqs.append(self._queue.get_nowait())
                continue
            except queue.Empty:
                pass
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                reqs.append(self._queue.get(
                    timeout=min(remaining, self.max_wait_s)))
            except queue.Empty:
                break
        return reqs

    def _scheduler(self):
        while not (self._stop.is_set() and self._queue.empty()):
            reqs = self._collect()
            if not reqs:
                continue
            try:
                self._dispatch(reqs)
            except Exception as e:  # noqa: BLE001 - fail this batch only
                for _, fut, _ in reqs:
                    if not fut.done():
                        fut.set_exception(e)

    def _assemble(self, reqs, bucket):
        """The padded batch on the host: {mod: fp32 (bucket, T, F)}, or
        {mod: (int8 (bucket, T, F), fp32 (bucket, T))} for an int8 bundle.
        A missing modality raises KeyError, a wrong shape ValueError."""
        t0 = time.perf_counter()
        quantize_s = 0.0
        T = self.meta["num_frames"]
        batch = {}
        for m, d in self.meta["modal_dims"].items():
            x = np.zeros((bucket, T, d), np.float32)
            for i, (clip, _, _) in enumerate(reqs):
                a = np.asarray(clip[m], np.float32)
                if a.shape != (T, d):
                    raise ValueError(f"{m}: a clip of shape {a.shape}, the "
                                     f"bundle takes {(T, d)}")
                x[i] = a
            if self._int8:
                tq = time.perf_counter()
                q, s = PackedFeatureStore._quantize_rows(
                    x.reshape(bucket * T, d))
                batch[m] = (q.reshape(bucket, T, d), s.reshape(bucket, T))
                quantize_s += time.perf_counter() - tq
            else:
                batch[m] = x
        self.host_s["quantize"] += quantize_s
        self.host_s["assemble"] += time.perf_counter() - t0 - quantize_s
        return batch

    def _dispatch(self, reqs):
        # _collect caps a batch at the largest bucket, so one fits
        bucket = next(b for b in self.buckets if b >= len(reqs))
        batch = self._assemble(reqs, bucket)
        t0 = time.perf_counter()
        self._inflight.acquire()
        t1 = time.perf_counter()
        self.host_s["slot_wait"] += t1 - t0
        try:
            slot = self._slots[bucket][self._turn[bucket]]
            self._turn[bucket] = (self._turn[bucket] + 1) % len(
                self._slots[bucket])
            for m, x in batch.items():
                if self._int8:
                    slot["in"][0][m].copy_(torch.from_numpy(x[0]))
                    slot["in"][1][m].copy_(torch.from_numpy(x[1]))
                else:  # cast to the serving dtype on the host
                    slot["in"][0][m].copy_(torch.from_numpy(x))
            t2 = time.perf_counter()
            self.host_s["stage"] += t2 - t1
            event = None
            with self.runner.stream_context():
                out = _as_tuple(self.runner.run(bucket, *slot["in"]))
                if self._cuda:
                    for host, dev in zip(slot["out"], out):
                        host.copy_(dev, non_blocking=True)
                    event = slot["event"]
                    event.record()
                    out = slot["out"]
            self.host_s["replay"] += time.perf_counter() - t2
        except Exception:
            self._inflight.release()
            raise
        self.batch_hist[bucket] += 1
        self._done_q.put((event, out, reqs))

    def _completer(self):
        while True:
            item = self._done_q.get()
            if item is None:
                return
            event, out, reqs = item
            try:
                t0 = time.perf_counter()
                if event is not None:
                    event.synchronize()
                t1 = time.perf_counter()
                self.host_s["device_wait"] += t1 - t0
                # copies: the slot's buffers serve a later dispatch
                arrays = [o.numpy().copy() for o in out]
                t_done = time.perf_counter()
                for i, (_, fut, t_sub) in enumerate(reqs):
                    row = tuple(a[i] for a in arrays)
                    fut.set_result((row if len(row) > 1 else row[0],
                                    t_done - t_sub))
                self.host_s["complete"] += time.perf_counter() - t1
            except Exception as e:  # noqa: BLE001 - to the callers
                for _, fut, _ in reqs:
                    if not fut.done():
                        fut.set_exception(e)
            finally:
                self._inflight.release()


def _percentiles(lat_s):
    if not len(lat_s):  # e.g. a duration shorter than one batch
        return {"p50_ms": None, "p95_ms": None, "p99_ms": None,
                "mean_ms": None}
    lat = np.sort(np.asarray(lat_s)) * 1e3

    def pick(p):
        return float(lat[min(len(lat) - 1,
                             int(round(p / 100 * (len(lat) - 1))))])

    return {"p50_ms": pick(50), "p95_ms": pick(95), "p99_ms": pick(99),
            "mean_ms": float(lat.mean())}


def _random_clip(meta, rng):
    return {m: rng.standard_normal((meta["num_frames"], d)).astype(np.float32)
            for m, d in meta["modal_dims"].items()}


def run_open_loop(server, rate_hz, duration_s, seed=0):
    """Poisson arrivals at ``rate_hz`` for ``duration_s`` from one thread;
    the achieved rate and the latency percentiles. Arrival times are drawn
    ahead on one clock, and a request whose time has passed is submitted at
    once, so the time a submit and a sleep take does not lower the offered
    rate."""
    rng = np.random.default_rng(seed)
    clip = _random_clip(server.meta, rng)
    futures = []
    t0 = time.perf_counter()
    t_next, t_end = t0, t0 + duration_s
    while t_next < t_end:
        wait = t_next - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        futures.append(server.submit(clip))
        t_next += rng.exponential(1.0 / rate_hz)
    t0_done = time.perf_counter()
    lats = [f.result(timeout=120)[1] for f in futures]
    return {"mode": "open-loop", "offered_rate": rate_hz,
            "requests": len(futures),
            "achieved_rate": len(futures) / duration_s,
            "drain_s_after_stop": time.perf_counter() - t0_done,
            **_percentiles(lats)}


def run_closed_loop(server, n_clients, duration_s, seed=0):
    """``n_clients`` threads, each submit -> wait -> repeat: saturated
    clips/s."""
    rng = np.random.default_rng(seed)
    clip = _random_clip(server.meta, rng)
    lats, lock = [], threading.Lock()
    stop = time.perf_counter() + duration_s
    counts = [0] * n_clients

    def client(ci):
        local = []
        while time.perf_counter() < stop:
            _, lat = server.submit(clip).result(timeout=120)
            local.append(lat)
            counts[ci] += 1
        with lock:
            lats.extend(local)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    return {"mode": "closed-loop", "clients": n_clients,
            "requests": int(sum(counts)),
            "throughput_clips_per_sec": sum(counts) / wall,
            **_percentiles(lats)}


def sweep(server, duration_s, report):
    """A closed loop at 2 x the largest bucket of clients (a second batch
    queued while one computes), then open loops at 0.25, 0.5 and 0.75 of
    its rate; ``report`` gets each result."""
    sat = run_closed_loop(server, 2 * server.buckets[-1], duration_s)
    report(sat)
    peak = sat["throughput_clips_per_sec"]
    for frac in (0.25, 0.5, 0.75):
        report(run_open_loop(server, frac * peak, duration_s))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bundle", required=True)
    ap.add_argument("--rate", type=float, default=None,
                    help="open-loop offered rate (requests/s)")
    ap.add_argument("--closed", type=int, default=None,
                    help="closed-loop client count")
    ap.add_argument("--sweep", action="store_true",
                    help="closed-loop saturation, then open loops at "
                         "fractions of it")
    ap.add_argument("--duration", type=float, default=15.0)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--max-inflight", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="append JSON results here")
    args = ap.parse_args(argv)

    server = BundleServer(args.bundle, max_wait_ms=args.max_wait_ms,
                          max_inflight=args.max_inflight, device=args.device)
    device = (torch.cuda.get_device_name(server.runner.device)
              if server._cuda else "cpu")

    def finish(res):
        res.update(buckets=server.buckets, max_wait_ms=args.max_wait_ms,
                   max_inflight=args.max_inflight,
                   input_dtype=server.meta["input_dtype"], device=device,
                   batch_hist={str(k): v for k, v in
                               server.batch_hist.items() if v},
                   host_s=server.take_host_times())
        print(json.dumps(res), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(res) + "\n")
        for b in server.batch_hist:
            server.batch_hist[b] = 0

    try:
        if args.sweep:
            sweep(server, args.duration, finish)
        elif args.closed:
            finish(run_closed_loop(server, args.closed, args.duration))
        else:
            finish(run_open_loop(server, args.rate or 100.0, args.duration))
    finally:
        server.close()


if __name__ == "__main__":
    main()
