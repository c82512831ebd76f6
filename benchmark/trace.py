"""Spans around the program's modules, and the reading of the profiler's trace.

The benchmark opens a ``record_function`` span around calls into the
program's layers with forward hooks registered from outside the program
(``Spans``). After a traced window, ``Trace`` reads the profiler's events:
each device operation (kernel, copy, set) with its interval, the host's
launch of each kernel through the launch's correlation id, and so the
benchmark spans its launch happened in. Intervals are in seconds on the
profiler's clock, which puts host and device events on one timeline.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional

import torch

PREFIX = "bench."


class Spans:
    """``record_function`` spans named ``bench.<name>`` around every call of
    the given modules, opened by a forward pre-hook and closed by a forward
    hook. ``remove()`` takes the hooks off."""

    def __init__(self):
        self._handles = []

    def add(self, module: torch.nn.Module, name: str) -> None:
        stack = []

        def enter(mod, args):
            rf = torch.profiler.record_function(PREFIX + name)
            rf.__enter__()
            stack.append(rf)

        def leave(mod, args, out):
            stack.pop().__exit__(None, None, None)

        self._handles += [module.register_forward_pre_hook(enter),
                          module.register_forward_hook(leave)]

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: float
    end: float
    spans: frozenset  # the benchmark spans (names without the prefix) around its launch
    launch: Optional[float]  # the host's launch, where the trace links it

    @property
    def dur(self) -> float:
        return self.end - self.start


def _union(intervals) -> List[tuple]:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class _Intervals:
    """The host intervals of one span name, which never nest in each other."""

    def __init__(self, intervals):
        self.items = sorted(intervals)
        self.starts = [s for s, _ in self.items]

    def containing(self, t: Optional[float]) -> Optional[tuple]:
        i = bisect.bisect_right(self.starts, t) - 1 if t is not None else -1
        if i >= 0 and self.items[i][1] >= t:
            return self.items[i]
        return None


def _activity(ev) -> str:
    at = getattr(ev, "activity_type", None)
    return str(at() if callable(at) else at or "")


class Trace:
    """The device operations and the benchmark's spans of one profile."""

    def __init__(self, prof):
        events = prof.profiler.kineto_results.events()
        launches: Dict[int, float] = {}
        device, spans, runtime = [], defaultdict(list), []
        for ev in events:
            start = ev.start_ns() * 1e-9
            end = start + ev.duration_ns() * 1e-9
            name = ev.name()
            if ev.device_type() != torch.autograd.DeviceType.CPU:
                # the device's copies of the host's annotations are no operations
                if not name.startswith(PREFIX) and "annotation" not in _activity(ev):
                    device.append((name, start, end, ev.correlation_id()))
            elif name.startswith(PREFIX):
                spans[name[len(PREFIX):]].append((start, end))
            elif name.startswith("cu"):  # the host's CUDA API calls: launches, copies, syncs
                launches[ev.correlation_id()] = start
                runtime.append((start, end))
        self.spans = {k: sorted(v) for k, v in spans.items()}
        self._index = {k: _Intervals(v) for k, v in self.spans.items()}
        ops = []
        for name, start, end, corr in device:
            t = launches.get(corr)
            inside = frozenset() if t is None else frozenset(
                k for k, ix in self._index.items() if ix.containing(t) is not None)
            ops.append(DeviceOp(name, start, end, inside, t))
        self.ops = sorted(ops, key=lambda o: o.start)
        self.runtime = runtime
        self.unlaunched = sum(1 for _, _, _, c in device if c not in launches)

    def summary(self) -> dict:
        """Counts that show whether the trace linked the device to the host."""
        return {"device_ops": len(self.ops), "unlinked": self.unlaunched,
                "in_spans": sum(1 for o in self.ops if o.spans),
                "spans": {k: len(v) for k, v in self.spans.items()}}

    def window(self):
        """(start, end) of the traced window: the ``unit`` spans' extent, or
        where the host was not traced, the extent of its CUDA calls (a unit
        launches at once and ends in a synchronisation)."""
        units = self.spans.get("unit") or self.runtime
        if not units:
            return None
        return min(s for s, _ in units), max(e for _, e in units)

    def busy_s(self, lo: float, hi: float) -> float:
        return sum(min(e, hi) - max(s, lo) for s, e in _union((o.start, o.end) for o in self.ops)
                   if e > lo and s < hi)

    def device_s(self, span: Optional[str] = None) -> float:
        """Summed duration of the device operations launched inside ``span``
        (all of them with None)."""
        return sum(o.dur for o in self.ops if span is None or span in o.spans)

    def covered_s(self, names) -> float:
        """Device time from the first to the last operation of each call of
        the spans ``names``, the calls' intervals merged: how long the
        device was taken by those calls."""
        per_call = defaultdict(list)
        for name in names:
            ix = self._index.get(name)
            if ix is None:
                continue
            for o in self.ops:
                if name in o.spans:
                    per_call[(name, ix.containing(o.launch))].append(o)
        calls = [(min(o.start for o in ops), max(o.end for o in ops)) for ops in per_call.values()]
        return sum(e - s for s, e in _union(calls))

    def idle_gaps(self, lo: float, hi: float, top: int = 10) -> list:
        """[name, seconds]: the device's idle time in [lo, hi], each gap named
        by the kind of operation the device waited for, summed by name, the
        largest first."""
        from .yardstick import kind_of

        gaps, t = defaultdict(float), lo
        for o in self.ops:
            if o.end <= lo or o.start >= hi:
                continue
            if o.start > t:
                gaps[f"waits for {kind_of(o.name)}"] += o.start - t
            t = max(t, o.end)
        if hi > t:
            gaps["waits for the unit's end"] += hi - t
        return [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]


class Tracer:
    """The profilers of a traced window: the first ``n`` units under the host
    and device profiler with the benchmark's spans, then on the card ``n``
    more under the device profiler alone, whose host runs at its own pace.
    ``before(i)``/``after(done)`` bracket each unit; ``after`` returns the
    seconds its profiler's stop took."""

    def __init__(self, span_modules, n: int, on_card: bool):
        self.span_modules, self.n, self.on_card = span_modules, n, on_card
        self.span_units = 0
        self._spans = self._prof = None
        self._done = []  # the stopped profilers, the spans' first

    def _start(self, activities) -> None:
        from torch.profiler import profile

        self._prof = profile(activities=activities)
        self._prof.start()

    def before(self, i: int) -> None:
        from torch.profiler import ProfilerActivity

        if i == 0:
            self._spans = Spans()
            for module, name in self.span_modules():
                self._spans.add(module, name)
            self._start([ProfilerActivity.CPU]
                        + ([ProfilerActivity.CUDA] if self.on_card else []))
        elif i == self.n and self.on_card:
            self._start([ProfilerActivity.CUDA])

    def after(self, done: int) -> float:
        import time

        if self._prof is None or done not in (self.n, 2 * self.n):
            return 0.0
        t = time.perf_counter()
        self._stop(done)
        return time.perf_counter() - t

    def _stop(self, done: int) -> None:
        self._prof.stop()
        self._done.append(self._prof)
        self._prof = None
        if self._spans is not None:
            self._spans.remove()
            self._spans = None
            self.span_units = done

    def finish(self, done: int) -> None:
        """Stop what still traces after ``done`` units: the window ended first."""
        if self._prof is not None:
            self._stop(done)

    def traces(self):
        """(the spans' trace, the device's trace or None)."""
        traces = [Trace(p) for p in self._done]
        self._done = []
        return (traces + [None, None])[:2]
