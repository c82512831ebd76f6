"""The optimizer's update: the mean time of the micro-steps that apply it
less the mean of those that do not, on the host's clock, over the window's
untraced micro-steps (all of them where the trace took every one)."""

LAYER = "training step"
UNIT = "s/update"
SOURCE = "host_clock"
MOVES = {"train": "s_per_micro_step"}


def read(window):
    flags = getattr(window.runner, "updates", None)
    if not flags:
        return None
    pairs = list(zip(window.unit_s, flags))
    if any(u for _, u in pairs[window.traced_units:]):
        pairs = pairs[window.traced_units:]
    up = [t for t, u in pairs if u]
    rest = [t for t, u in pairs if not u]
    if not up or not rest:
        return None
    return sum(up) / len(up) - sum(rest) / len(rest)
