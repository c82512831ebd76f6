"""Seconds a training micro-step, the optimizer's updates among them (``_per_unit``)."""

from benchmark.metrics._per_unit import read  # noqa: F401

UNIT = "s/micro-step"
SOURCE = "host_clock"
