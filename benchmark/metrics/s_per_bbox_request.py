"""Seconds a stage-1 request, decode and select included (``_per_unit``)."""

from benchmark.metrics._per_unit import read  # noqa: F401

UNIT = "s/request"
SOURCE = "host_clock"
