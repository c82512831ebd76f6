"""Tracing and timing helpers of the port's tools.

Counterpart of ``ctrlv_tpu/utils/profiling.py``:

- ``trace(log_dir)``: ``torch.profiler`` over the CPU and, where there is a
  card, CUDA, exporting a Chrome trace into ``log_dir``; a no-op without one.
- ``StepTimer``: wall-clock time a step with warm-up exclusion and the same
  percentile summary as the JAX package's. On a CUDA device it synchronises
  the card on entering and on leaving a step, so that a step's time is the
  device's work and not the host's time to enqueue it.
- ``annotate(name)``: a span the profiler shows (``record_function``), and an
  NVTX range where there is a card.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile the block into a Chrome trace under ``log_dir`` and yield the
    profiler; with no ``log_dir``, do nothing and yield None."""
    if not log_dir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    handler = torch.profiler.tensorboard_trace_handler(log_dir)
    with torch.profiler.profile(activities=activities, on_trace_ready=handler) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str):
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


class StepTimer:
    """``with timer:`` around each step. The first ``warmup`` steps are left
    out of ``times`` and ``summary()``; ``last_s`` is the last step's time,
    warm-up or not. ``device``: where it is a CUDA device, the card is
    synchronised on entering and on leaving each step."""

    def __init__(self, warmup: int = 1, device=None):
        self.warmup = warmup
        self._sync = device is not None and torch.device(device).type == "cuda"
        self._times: List[float] = []
        self._t0: Optional[float] = None
        self._count = 0
        self.last_s: Optional[float] = None

    def __enter__(self):
        if self._sync:
            torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync:
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0
        self.last_s = dt
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)

    @property
    def times(self) -> List[float]:
        return list(self._times)

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {"steps": 0}
        arr = np.asarray(self._times)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
            "min_s": float(arr.min()),
        }
