"""Fixtures of the benchmark's own tests: a checkout-like root whose
``BENCHMARK.json`` names the two sampling cells and the training cell on tiny
configurations (the files under ``tests/data``), so that a whole run goes
through on the CPU. The training cell is not in the repository's
``BENCHMARK.json``; its entries are kept in ``tests/data/controlnet.train.entries.json``,
which a root made here adds.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import io
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)  # the tests run in several workers at once
REPO = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY = {"box2video.serve": ("tiny-box2video", "tiny.box2video"),
        "bbox.predict5": ("tiny-bbox", "tiny.bbox"),
        "controlnet.train": ("tiny-box2video", "tiny.train")}
LATER = DATA / "controlnet.train.entries.json"  # entries of a cell kept out of BENCHMARK.json


def with_later_cells(spec: dict) -> dict:
    """``spec`` with the kept entries added where it lacks them."""
    for key, entries in json.loads(LATER.read_text()).items():
        names = {e["name"] for e in spec[key]}
        spec[key] += [e for e in entries if e["name"] not in names]
    return spec


def make_root(tmp: Path) -> Path:
    """A root with the repository's ``BENCHMARK.json`` whose cells run the
    tiny configurations and traffic, and the benchmark's metric readers."""
    bench = tmp / "benchmark"
    for sub in ("configs", "traffic"):
        (bench / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(REPO / "benchmark" / "metrics", bench / "metrics", dirs_exist_ok=True)
    spec = with_later_cells(json.loads((REPO / "BENCHMARK.json").read_text()))
    spec["configs"], cells = [], {w["name"]: w for w in spec["workloads"]}
    for cell, (config, traffic) in TINY.items():
        shutil.copy(DATA / f"{config}.json", bench / "configs" / f"{config}.json")
        shutil.copy(DATA / f"{traffic}.json", bench / "traffic" / f"{traffic}.json")
        cells[cell].update(config=config, traffic=traffic)
    for config in sorted({c for c, _ in TINY.values()}):
        spec["configs"].append({"name": config, "source": "test", "reduced": [],
                                "file": f"benchmark/configs/{config}.json", "why": "test"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_root(tmp_path)


def run_tiny(root: Path, workload: str, seed: int = 2**31 + 11, seconds: float = 0.5,
             trace: int = 0, argv=()):
    """(result, standard output, standard error) of a run on the CPU;
    ``argv``: further options."""
    from benchmark import run

    out, err = io.StringIO(), io.StringIO()
    result = run.run(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                      "--trace", str(trace), *argv], root=root, device="cpu",
                     chips=lambda n: None, out=out, err=err)
    return result, out.getvalue(), err.getvalue()
