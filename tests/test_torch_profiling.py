"""The port's tracing and timing helpers (``ctrlv_tpu_torch.utils.profiling``)
against the JAX package's ``ctrlv_tpu.utils.profiling``.

- ``StepTimer``: given the same step durations (``time.perf_counter``
  patched), the summary equals the JAX timer's to 1e-12, warm-up exclusion
  included; on a CUDA device it synchronises the card on entering and on
  leaving a step, and on the CPU never.
- ``trace(None)`` is a no-op; ``trace(dir)`` on the CPU writes a Chrome trace
  that holds an ``annotate`` span.
"""

import glob
import json
import time

import numpy as np
import pytest
import torch

from ctrlv_tpu.utils import profiling as jax_profiling
from ctrlv_tpu_torch.utils import profiling


def _timed(timer_cls, durations, monkeypatch, **kwargs):
    """Run ``timer_cls(**kwargs)`` over steps of the given durations, the
    clock patched so that each step takes exactly its duration."""
    clock = iter(np.cumsum([0.0] + [x for d in durations for x in (d, 1.0)]))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(clock)))
    timer = timer_cls(**kwargs)
    for _ in durations:
        with timer:
            pass
    monkeypatch.undo()
    return timer


@pytest.mark.parametrize("warmup", [0, 1, 3])
@pytest.mark.parametrize("n", [1, 4, 9])
def test_step_timer_summary_matches_jax(monkeypatch, warmup, n):
    durations = np.random.default_rng(10 * warmup + n).uniform(0.01, 3.0, n).tolist()
    got = _timed(profiling.StepTimer, durations, monkeypatch, warmup=warmup).summary()
    want = _timed(jax_profiling.StepTimer, durations, monkeypatch, warmup=warmup).summary()
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])
    if n <= warmup:
        assert got == {"steps": 0}


def test_step_timer_times_and_last_step(monkeypatch):
    durations = [0.5, 0.25, 2.0, 1.0]
    timer = _timed(profiling.StepTimer, durations, monkeypatch, warmup=1)
    assert timer.times == durations[1:]
    assert timer.last_s == durations[-1]


@pytest.mark.parametrize("device, syncs", [("cuda", 4), (torch.device("cuda", 0), 4),
                                           ("cpu", 0), (None, 0)])
def test_step_timer_synchronises_only_a_card(monkeypatch, device, syncs):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(a))
    timer = profiling.StepTimer(warmup=0, device=device)
    for _ in range(2):
        with timer:
            pass
    assert len(calls) == syncs
    assert len(timer.times) == 2


def test_trace_without_a_directory_does_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for log_dir in (None, ""):
        with profiling.trace(log_dir) as prof:
            torch.ones(3).sum()
        assert prof is None
    assert list(tmp_path.iterdir()) == []


def test_trace_writes_a_chrome_trace_with_the_span(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("probe span"):
            torch.ones(16, 16) @ torch.ones(16, 16)
    assert prof is not None
    files = glob.glob(str(tmp_path / "*.json"))
    assert len(files) == 1
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "probe span" for e in events)
    assert any(e.get("name") == "aten::mm" for e in events)


def test_annotate_is_a_profiler_span():
    with torch.profiler.profile() as prof:
        with profiling.annotate("outer"):
            torch.ones(4).sum()
    assert "outer" in {e.key for e in prof.key_averages()}
