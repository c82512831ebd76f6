"""The order in which the tier-1 run hands its test files to xdist's
workers (``tests/torch_file_order_plugin.py``): by
``tests/file_seconds.json``, longest first, with the longest files cut."""

import json
import os
from types import SimpleNamespace

import torch_file_order_plugin as plugin
from xdist.scheduler import LoadFileScheduling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sorted(nodeids, seconds):
    units = plugin.work_units(nodeids, seconds, workers=1)  # no file is cut
    return [nodeid for ids in units.values() for nodeid in ids]


def test_every_entry_is_a_test_file():
    with open(plugin.FILE_SECONDS) as f:
        seconds = json.load(f)
    assert seconds
    for path, s in seconds.items():
        assert path.startswith("tests/test_") and path.endswith(".py"), path
        assert os.path.isfile(os.path.join(ROOT, path)), path
        assert isinstance(s, int) and s >= 0, path


def test_the_tests_of_a_file_keep_their_order():
    ids = ["tests/test_a.py::z", "tests/test_b.py::y", "tests/test_a.py::a",
           "tests/test_b.py::b[2]", "tests/test_b.py::b[1]"]
    assert _sorted(ids, {"tests/test_a.py": 5, "tests/test_b.py": 9}) == [
        "tests/test_b.py::y", "tests/test_b.py::b[2]", "tests/test_b.py::b[1]",
        "tests/test_a.py::z", "tests/test_a.py::a"]


def test_a_file_missing_from_the_table_comes_first():
    ids = ["tests/test_a.py::t", "tests/test_b.py::t", "tests/test_new.py::t[1]",
           "tests/test_new.py::t[0]"]
    assert _sorted(ids, {"tests/test_a.py": 600, "tests/test_b.py": 1}) == [
        "tests/test_new.py::t[1]", "tests/test_new.py::t[0]", "tests/test_a.py::t",
        "tests/test_b.py::t"]


def test_files_of_equal_seconds_keep_their_order():
    ids = ["tests/test_c.py::t", "tests/test_a.py::t", "tests/test_b.py::t"]
    table = {"tests/test_a.py": 7, "tests/test_b.py": 7, "tests/test_c.py": 7}
    assert _sorted(ids, table) == ids
    assert _sorted(ids[::-1], table) == ids[::-1]


def test_a_file_longer_than_a_share_is_cut_into_runs_of_consecutive_tests():
    ids = [f"tests/test_long.py::t{i}" for i in range(7)] + ["tests/test_a.py::t",
                                                            "tests/test_new.py::t"]
    # 2 workers: a share is 600 s, so 700 s make 2 runs of consecutive tests
    units = plugin.work_units(ids, {"tests/test_long.py": 700, "tests/test_a.py": 300,
                                    "tests/test_b.py": 200}, workers=2)
    assert {unit: len(tests) for unit, tests in units.items()} == {
        "tests/test_new.py": 1,  # not in the table: first, and never cut
        "tests/test_long.py::0": 4, "tests/test_long.py::1": 3,  # 350 s each
        "tests/test_a.py": 1}  # 300 s: not longer than a share
    assert list(units) == ["tests/test_new.py", "tests/test_long.py::0", "tests/test_long.py::1",
                           "tests/test_a.py"]
    assert sum(units.values(), []) == ids[-1:] + ids[:7] + ids[-2:-1]


class _Worker:
    shutting_down = False
    gateway = SimpleNamespace(id="gw")

    def __init__(self, handed):
        self.handed = handed

    def send_runtest_some(self, indices):
        self.handed.append(indices)

    def shutdown(self):
        self.shutting_down = True


def test_xdist_hands_out_the_units_longest_first():
    """Through xdist's own scheduler: fails if a version of xdist stops
    asking the overridden methods for the units and their order."""
    ids = (["tests/test_b.py::t", "tests/test_a.py::t"]
           + [f"tests/test_long.py::t{i}" for i in range(6)] + ["tests/test_new.py::t"])
    table = {"tests/test_long.py": 600, "tests/test_a.py": 150, "tests/test_b.py": 50}
    config = SimpleNamespace(getvalue={"dist": "loadfile", "tx": ["2*popen"]}.get,
                             option=SimpleNamespace(loadscopereorder=True))
    assert plugin.pytest_xdist_make_scheduler(
        SimpleNamespace(getvalue={"dist": "load"}.get), None) is None
    sched = plugin.longest_first(config, None, table)  # 2 workers: a share is 400 s
    assert isinstance(sched, LoadFileScheduling)
    handed = []
    workers = [_Worker(handed), _Worker(handed)]
    for w in workers:
        sched.add_node(w)
    for w in workers:
        sched.add_node_collection(w, ids)
    sched.schedule()
    while sched.has_pending:
        for w in workers:
            for unit in sched.assigned_work[w].values():
                todo = [n for n, done in unit.items() if not done]
                if todo:
                    sched.mark_test_complete(w, ids.index(todo[0]))
                    break
    assert [[ids[i] for i in indices] for indices in handed] == [
        ["tests/test_new.py::t"], ids[2:5], ids[5:8], ["tests/test_a.py::t"],
        ["tests/test_b.py::t"]]
