"""The share of the traced window in which no operation runs on the device:
1 - (union of the device operations' intervals) / window, from the units
traced for the device alone (no host tracing, which would slow the host and
widen the gaps); from the units traced with the spans where those are all."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = {"box2video": "s_per_clip", "bbox": "s_per_bbox_request", "train": "s_per_micro_step"}


def read(window):
    trace = window.device_trace or window.trace
    if trace is None or not trace.ops:
        return None
    lo, hi = trace.window()
    return 100.0 * (1.0 - trace.busy_s(lo, hi) / (hi - lo))
