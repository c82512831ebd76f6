"""The share of the traced window's device time spent in PyTorch's
elementwise, copy and cast kernels, by the kinds of ``yardstick.KERNEL_KINDS``."""

from benchmark.yardstick import kind_of

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = {"train": "s_per_micro_step"}
KINDS = ("copies and casts", "elementwise (adds, muls, gelu, SiLU)")


def read(window):
    trace = window.device_trace or window.trace
    if trace is None:
        return None
    lo, hi = trace.window()
    ops = [o for o in trace.ops if lo <= o.start < hi]
    total = sum(o.dur for o in ops)
    if not total:
        return None
    return 100.0 * sum(o.dur for o in ops if kind_of(o.name) in KINDS) / total
