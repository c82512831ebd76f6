"""The whole unit's share of the card's dense peak: the benchmark's FLOPs of
a unit (``yardstick.count`` on the reference models) times the units
completed, over the window's wall time; the units traced with the spans,
whose host the profiler slows, are left out of both where others remain."""

from benchmark.yardstick import PEAK_FLOPS

LAYER = "whole step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = {"box2video": "s_per_clip", "bbox": "s_per_bbox_request", "train": "s_per_micro_step"}


def read(window):
    if window.runner.device.type != "cuda":
        return None
    flops, _ = window.work()
    seconds, units = window.clean()
    return 100.0 * flops * units / seconds / PEAK_FLOPS[window.runner.config["dtype"]]
