"""Device time of a short call, apart from the host's time to enqueue it.

``device_ms`` enqueues ``inner`` calls behind ``torch.cuda._sleep``, which
keeps the card busy while the host enqueues them, and records the start event
after the sleep: the window between the two events then holds only the
calls' own device work, however long the host takes to launch each. A window
counts only if the card had not reached its start event when the host had
enqueued the last call (``Event.query``); otherwise the sleep doubles and the
timing is taken again.
"""

from __future__ import annotations

import time

import numpy as np
import torch

_SLEEP_CYCLES = 2_000_000  # about 1 ms at the H100's clock
_MAX_SLEEP_CYCLES = 1 << 31


def device_ms(fn, reps: int = 7, warmup: int = 2, inner: int = 8) -> tuple[float, float]:
    """(median device ms per call, median host µs to enqueue one call) over
    ``reps`` windows of ``inner`` back-to-back calls of ``fn``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles, dev, host = _SLEEP_CYCLES, [], []
    while len(dev) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        t1 = time.perf_counter()
        end.record()
        clean = not start.query()  # the card was still asleep when the host was done
        torch.cuda.synchronize()
        if not clean:
            cycles *= 2
            if cycles > _MAX_SLEEP_CYCLES:
                raise RuntimeError("device_ms: the host did not enqueue the calls within the "
                                   "longest sleep")
            continue
        dev.append(start.elapsed_time(end) / inner)
        host.append(1e6 * (t1 - t0) / inner)
    return float(np.median(dev)), float(np.median(host))
