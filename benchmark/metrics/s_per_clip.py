"""Seconds a Box2Video clip (``_per_unit``)."""

from benchmark.metrics._per_unit import read  # noqa: F401

UNIT = "s/clip"
SOURCE = "host_clock"
