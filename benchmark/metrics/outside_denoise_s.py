"""A request's time on the device's timeline that no denoise call covers:
the traced window less the merged spans from the first to the last device
operation of each UNet and ControlNet call, a request. CLIP, the VAE
encodes and decode, the select and the host's gaps between them."""

LAYER = "pipelines"
UNIT = "s/request"
SOURCE = "device_trace"
MOVES = {"box2video": "s_per_clip", "bbox": "s_per_bbox_request"}


def read(window):
    trace = window.trace
    if trace is None:
        return None
    covered = trace.covered_s(("unet", "controlnet"))
    if not covered:
        return None
    lo, hi = window.traced_window()
    return ((hi - lo) - covered) / window.traced_units
