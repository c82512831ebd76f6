"""Device time of the kernels launched inside the benchmark's spans around
the program's UNet and ControlNet calls, a denoise step."""

LAYER = "denoise step"
UNIT = "ms/step"
SOURCE = "device_trace"
MOVES = {"box2video": "s_per_clip", "bbox": "s_per_bbox_request"}


def read(window):
    trace = window.trace
    if trace is None or not window.steps:
        return None
    ops = [o for o in trace.ops if "unet" in o.spans or "controlnet" in o.spans]
    if not ops:
        return None
    return 1e3 * sum(o.dur for o in ops) / (window.steps * window.traced_units)
