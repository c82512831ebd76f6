"""Whole runs of the cells on the CPU at tiny sizes: the result
line the contract asks for, the rates over every unit, the refusals, and a
cell, a configuration and a metric added as files alone."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import run
from conftest import DATA, REPO, run_tiny, with_later_cells

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("workload", ["box2video.serve", "bbox.predict5", "controlnet.train"])
def test_last_line_meets_the_contract(tiny_root, workload):
    result, out, err = run_tiny(tiny_root, workload)
    last = json.loads(out.strip().splitlines()[-1])
    assert last == json.loads(json.dumps(result))
    assert list(last) == KEYS
    assert last["correct"] is True and last["failed"] == 0
    assert set(last["metrics"]) == {"setup_s", run.metrics_of(run.load_spec(tiny_root), workload)[0][1]["name"]}
    for m in last["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(last["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    checks = err.strip().splitlines()[-len(last["checks"]):]
    for line, (name, c) in zip(checks, last["checks"].items()):
        assert line.startswith(f"check {name}: ") and set(c) == {"value", "limit"}


@pytest.mark.parametrize("trace", [0, 1])
def test_rate_covers_every_unit_of_the_window(tiny_root, trace):
    result, out, _ = run_tiny(tiny_root, "box2video.serve", seconds=0.8, trace=trace)
    times = next(json.loads(line) for line in out.splitlines() if '"unit_s"' in line)
    n = result["attempted"]
    assert n == len(times["unit_s"])
    assert sum(times["unit_s"][:-1]) < 0.8 <= times["window_s"]  # the one in flight finished
    assert times["window_s"] >= sum(times["unit_s"])
    if not trace:
        rate = result["metrics"]["s_per_clip"]["value"]
        assert rate == pytest.approx(times["window_s"] / n)


def test_training_rate_counts_the_updates(tiny_root):
    result, out, _ = run_tiny(tiny_root, "controlnet.train", seconds=12.0)
    times = next(json.loads(line) for line in out.splitlines() if '"unit_s"' in line)
    assert len(times["updates"]) == len(times["unit_s"]) == result["attempted"]
    assert any(times["updates"]) and not all(times["updates"])
    rate = result["metrics"]["s_per_micro_step"]["value"]
    assert rate == pytest.approx(times["window_s"] / result["attempted"])


def test_traced_run_reports_per_layer_metrics_and_breakdown(tiny_root):
    result, _, _ = run_tiny(tiny_root, "bbox.predict5", trace=1)
    assert list(result)[-1] == "checks" and "breakdown" in result
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["device"]["window_s"] > 0
    assert "setup_s" not in result["metrics"]  # trace 1 reports the per-layer metrics only


def test_cell_config_and_metric_added_as_files_are_found(tiny_root):
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    shutil.copy(DATA / "tiny-box2video.json", tiny_root / "benchmark/configs/added.json")
    traffic = json.loads((DATA / "tiny.box2video.json").read_text())
    traffic["steps"] = 3
    (tiny_root / "benchmark/traffic/added.serve.json").write_text(json.dumps(traffic))
    (tiny_root / "benchmark/metrics/units_done.py").write_text(
        'LAYER = "pipelines"\nUNIT = "1"\nSOURCE = "program_counter"\n'
        'MOVES = {"added": "s_per_clip"}\n\n\ndef read(window):\n    return float(window.units)\n')
    spec["configs"].append({"name": "added", "source": "test", "reduced": [],
                            "file": "benchmark/configs/added.json", "why": "test"})
    spec["workloads"].append({"name": "added.serve", "config": "added", "traffic": "added.serve",
                              "chips": 1, "why": "test"})
    spec["end_to_end"][1]["workloads"].append("added.serve")
    spec["per_layer"].append({"name": "units_done.added", "unit": "1", "better": "higher",
                              "source": "program_counter", "layer": "pipelines",
                              "moves": "s_per_clip", "workloads": ["added.serve"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    result, _, _ = run_tiny(tiny_root, "added.serve", trace=1)
    assert result["metrics"]["units_done.added"]["value"] == result["attempted"]
    result, _, _ = run_tiny(tiny_root, "added.serve")
    assert set(result["metrics"]) == {"setup_s", "s_per_clip"}


@pytest.mark.parametrize("key,value", [("unit", "s"), ("moves", "s_per_clip"),
                                       ("layer", "kernels"), ("source", "device_trace")])
def test_refuses_a_reader_that_declares_other_than_the_entry(tiny_root, key, value):
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    entry = next(m for m in spec["per_layer"] if m["name"] == "update_s.train")
    entry[key] = value
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    with pytest.raises(run.Refused, match="declares"):
        run_tiny(tiny_root, "controlnet.train", trace=1)


def test_the_repositorys_readers_declare_what_benchmark_json_lists():
    spec = with_later_cells(run.load_spec(REPO))
    for m in spec["end_to_end"] + spec["per_layer"]:
        run.reader(REPO, m)


def test_refuses_a_loaded_jax_module(tiny_root, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    with pytest.raises(run.Refused, match="jax"):
        run_tiny(tiny_root, "box2video.serve")


def test_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, 'benchmark/tests'); from conftest import make_root,"
            " run_tiny; import tempfile, pathlib; from benchmark import run;"
            " run_tiny(make_root(pathlib.Path(tempfile.mkdtemp())), 'bbox.predict5');"
            " print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "ctrlv_tpu.models", type(sys)("ctrlv_tpu.models"))
    assert run.forbidden_modules() == ["ctrlv_tpu.models"]
    monkeypatch.delitem(sys.modules, "ctrlv_tpu.models")
    assert "ctrlv_tpu_torch" not in " ".join(run.forbidden_modules())


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="", CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "box2video.serve",
                          "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "refused" in out.stderr
    with pytest.raises(run.Refused, match="cannot be imported|not from the checkout"):
        run.check_program(tmp_path)
