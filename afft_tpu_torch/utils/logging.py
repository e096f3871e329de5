"""Experiment tracking and console logging.

Port of afft_tpu/utils/logging.py. The reference logs to wandb (reference train.py:414-425). wandb is optional
here: when importable and configured it receives the same per-epoch metric
dicts; regardless, every epoch's metrics append to a JSONL file next to the
checkpoints so runs are inspectable without external services.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

log = logging.getLogger(__name__)


def human_format(num) -> str:
    """1234567 -> '1.2M' (reference common/utils.py:253-259)."""
    num = float(num)
    magnitude = 0
    while abs(num) >= 1000:
        magnitude += 1
        num /= 1000.0
    return "{}{}".format(
        "{:f}".format(num).rstrip("0").rstrip("."),
        ["", "K", "M", "G", "T", "P"][magnitude])


class ExperimentLogger:
    """JSONL metrics log + optional wandb mirror."""

    def __init__(self, out_dir: str, project_name: str, experiment_name: str,
                 use_wandb: bool = True, config: Optional[dict] = None):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.jsonl_path = os.path.join(out_dir, "metrics.jsonl")
        self._wandb = None
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb
                wandb.init(project=project_name, name=experiment_name,
                           config=config or {})
            except Exception as e:  # not installed / not logged in
                log.info("wandb unavailable (%s); JSONL logging only", e)

    def log(self, metrics: Dict, step: Optional[int] = None):
        payload = {"_time": time.time()}
        if step is not None:
            payload["_step"] = step
        for k, v in metrics.items():
            if v is None:
                continue
            try:
                payload[k] = float(v)
            except (TypeError, ValueError):
                continue
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(payload) + "\n")
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in payload.items()
                             if not k.startswith("_")}, step=step)

    def summary(self, key: str, value):
        if self._wandb is not None and self._wandb.run is not None:
            self._wandb.run.summary[key] = value
        # newline-delimited records: append-only across resumed runs
        # (a .json name would become invalid JSON on the second write)
        with open(os.path.join(self.out_dir, "summary.jsonl"), "a") as f:
            f.write(json.dumps({key: value}) + "\n")


class ProfilerHook:
    """torch.profiler trace over a step window (cfg-gated).

    The reference has only hand-rolled host timers (SURVEY §5.1); the
    device-side picture needs a real trace. Enable with
    ``+profile_dir=<dir>`` (and ``+profile_start_step`` /
    ``+profile_stop_step``); the chrome trace, a table of the ops by host
    time and ``window.json`` land in that directory. ``window.json`` holds
    the window's steps, its wall time from the first traced step to a
    synchronisation after the last, the device kernels' summed time and
    count, and the device's busy share of the wall.
    """

    def __init__(self, trace_dir: Optional[str],
                 start_step: int = 10, stop_step: int = 20):
        self.trace_dir = trace_dir
        self.start_step = start_step
        self.stop_step = stop_step
        self._prof = None
        self._t0 = self._first = self._last = 0

    def step(self, step: int):
        if self.trace_dir is None:
            return
        if self.start_step <= step < self.stop_step and self._prof is None:
            # >= not ==: a resumed run restores the step counter past
            # start_step and must still honor the requested window
            import torch
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
            self._t0 = time.perf_counter()
            self._first = self._last = step
            log.info("profiler trace started -> %s", self.trace_dir)
        elif self._prof is not None:
            self._last = step
            if step >= self.stop_step:
                self.close()

    def close(self):
        if self._prof is None:
            return
        import torch
        from torch.autograd import DeviceType
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - self._t0) * 1e3
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        window = {"steps": self._last - self._first, "wall_ms": wall_ms,
                  "device_busy_ms": busy_ms, "device_kernels": len(kernels),
                  "busy_share": busy_ms / wall_ms if wall_ms else None}
        os.makedirs(self.trace_dir, exist_ok=True)
        with open(os.path.join(self.trace_dir, "window.json"), "w") as f:
            json.dump(window, f)
        log.info("profiler window: %s", json.dumps(window))
        prof.export_chrome_trace(os.path.join(self.trace_dir, "trace.json"))
        with open(os.path.join(self.trace_dir, "ops.txt"), "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_cpu_time_total", row_limit=60))
        log.info("profiler trace stopped -> %s", self.trace_dir)
