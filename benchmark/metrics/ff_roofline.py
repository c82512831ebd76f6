"""The least time of every FeedForward call of a unit (the benchmark's count of
its operations and bytes at the configuration's shapes, ``yardstick.py``)
over the device time of the kernels launched inside the spans around the
program's ``FeedForward`` modules, in the traced units."""

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = {"box2video": "s_per_clip"}


def read(window):
    trace = window.trace
    if trace is None:
        return None
    spent = trace.device_s("feed_forward")
    if not spent:
        return None
    _, sites = window.work()
    least = sum(s.least_s(window.runner.config["dtype"]) for s in sites if s.kind == "feed_forward")
    return 100.0 * least * window.traced_units / spent
