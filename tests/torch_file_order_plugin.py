"""The order in which a ``-n N --dist loadfile`` run hands out its work.

xdist makes each test file one unit of work and hands the units out with
the files of most tests first. That leaves the longest files, a few slow
tests each, to the end of the run, which then ends on one or two busy
workers while the others idle. Here the units go out longest first by
their seconds in a tier-1 run (``file_seconds.json``); a file the table
lacks counts as the heaviest, so a new file goes first. A file longer than
a worker's share of the table would still end the run alone, so it is cut
into the fewest runs of consecutive tests of at most a share, one unit
each; consecutive, since neighbouring tests (a parametrised test's cases)
tend to share fixtures and compiled programs. Each cut unit builds its
file's module fixtures again, and cutting at half a share made a cold run
slower, not faster.

The hook is registered from the repository root's ``conftest.py``. A run
without xdist, or with another ``--dist``, is not touched; the workers
collect and run each unit's tests in their own order.
"""

import collections
import json
import math
import os

import pytest

FILE_SECONDS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "file_seconds.json")


def _file(nodeid):
    return nodeid.split("::", 1)[0]


def work_units(nodeids, seconds, workers):
    """``nodeids``' units of work on ``workers`` workers, longest first: a
    dict of each unit's name to its node ids in their order. A unit is a
    file, or ``file::j`` for the ``j``-th of the ``k`` runs of consecutive
    tests that a file longer than a worker's share of ``seconds`` is cut
    into, each of ``1 / k`` of the file's seconds. The sort is stable:
    units of equal seconds keep their order in ``nodeids``."""
    share = sum(seconds.values()) / workers
    count = collections.Counter(map(_file, nodeids))
    seen = collections.Counter()
    units, unit_seconds = {}, {}
    for nodeid in nodeids:
        path = _file(nodeid)
        k = max(math.ceil(seconds.get(path, 0) / share), 1)
        unit = f"{path}::{seen[path] * k // count[path]}" if k > 1 else path
        units.setdefault(unit, []).append(nodeid)
        unit_seconds[unit] = seconds.get(path, math.inf) / k
        seen[path] += 1
    return dict(sorted(units.items(), key=lambda unit: -unit_seconds[unit[0]]))


def longest_first(config, log, seconds):
    """xdist's ``LoadFileScheduling``, handing out ``work_units`` in order."""
    from xdist.scheduler import LoadFileScheduling

    class LongestFirst(LoadFileScheduling):
        units = None

        def _split_scope(self, nodeid):
            if self.units is None:  # first called once every worker's collection is in
                self.order = work_units(self.collection, seconds, self.numnodes)
                self.units = {n: unit for unit, ids in self.order.items() for n in ids}
            return self.units[nodeid]

        def _assign_work_unit(self, node):
            for unit in self.order:  # the queue, longest first; xdist pops its head
                if unit in self.workqueue:
                    self.workqueue.move_to_end(unit)
            super()._assign_work_unit(node)

    return LongestFirst(config, log)


@pytest.hookimpl(tryfirst=True, optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None  # xdist makes its own
    with open(FILE_SECONDS) as f:
        return longest_first(config, log, json.load(f))
