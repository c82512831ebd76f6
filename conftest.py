"""Hooks for every pytest run from the repository root: the order of a
``--dist loadfile`` run's work (``tests/torch_file_order_plugin.py``)."""

from tests.torch_file_order_plugin import pytest_xdist_make_scheduler  # noqa: F401
