"""The comparison that decides ``correct``: the reference is the program's
function, the control fails it, and a run whose timed path is broken
underneath comes out not correct, once for each fault a sampling cell can
have. Tiny configurations on the CPU; the harness's look for a card is
skipped, the rest of a run is driven."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest
import torch

from benchmark.cells import serving
from benchmark.reference import weights
from conftest import DATA, REPO, TINY, run_tiny

TINY_KIND = {"box2video.serve": "box2video", "bbox.predict5": "bbox_predict",
             "controlnet.train": "controlnet_train"}


def tiny_cell(workload, seed=3):
    from benchmark import run

    config, traffic = TINY[workload]
    cfg = json.loads((DATA / f"{config}.json").read_text())
    tr = json.loads((DATA / f"{traffic}.json").read_text())
    return run.cell_class(tr["kind"])(cfg, tr, seed, "cpu")


@pytest.mark.parametrize("name", ["unet", "controlnet", "vae", "clip"])
def test_reference_computes_the_programs_function(name):
    """Both in float32 with the same weights: the plain reference and the
    program's model agree to rounding."""
    cfg = json.loads((DATA / "tiny-box2video.json").read_text())
    ref = serving.reference_model(name, cfg)
    views = weights.make_weights(ref, 5, "cpu", torch.float32)
    prog = serving.hand_weights(serving.port_model(name, cfg), views)
    ref = weights.load_reference(ref, views, "cpu")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        if name in ("unet", "controlnet"):
            x = torch.randn(2, 3, 8, 8, 8, generator=g)
            args = (x, torch.tensor(0.3), torch.randn(2, 1, 48, generator=g), torch.rand(2, 3))
            if name == "unet":
                a, b = prog(*args), ref(*args)
            else:
                cond = torch.randn(2, 3, 8, 8, 4, generator=g)
                a, b = prog(*args, cond), ref(*args, cond)
                a = torch.cat([t.flatten() for t in a[0]] + [a[1].flatten()])
                b = torch.cat([t.flatten() for t in b[0]] + [b[1].flatten()])
        elif name == "vae":
            img = torch.rand(4, 16, 16, 3, generator=g) * 2 - 1
            a, b = prog.encode(img), ref.encode(img)
            z = torch.randn(4, 8, 8, 4, generator=g)
            a = torch.cat([a.flatten(), prog.decode(z, 2).flatten()])
            b = torch.cat([b.flatten(), ref.decode(z, 2).flatten()])
        else:
            from ctrlv_tpu_torch.models.clip_vision import clip_preprocess

            img = torch.rand(2, 20, 24, 3, generator=g) * 2 - 1
            a, b = prog(clip_preprocess(img, 28)), ref(img)
    assert serving.rel(a, b) < 1e-5


@pytest.mark.parametrize("workload", ["box2video.serve", "bbox.predict5", "controlnet.train"])
def test_control_fails_the_limits(workload):
    cell = tiny_cell(workload)
    cell.build()
    cell.warm_up()
    cell.unit(0)
    if hasattr(cell, "complete"):
        cell.complete()
    cell.free()
    readings = cell.check(control=True)
    assert all(p <= limit for _, p, _, limit in readings)
    assert any(c is not None and c > limit for _, _, c, limit in readings)


@pytest.mark.parametrize("workload", ["box2video.serve", "controlnet.train"])
def test_a_run_with_the_control_in_the_programs_place_is_not_correct(tiny_root, workload):
    result, out, _ = run_tiny(tiny_root, workload, argv=["--control", "1"])
    assert result["correct"] is False
    readings = next(json.loads(line) for line in out.splitlines() if '"readings"' in line)
    for name, c in result["checks"].items():
        r = readings["readings"][name]
        assert c["value"] == (r["control"] if r["control"] is not None else r["program"])


@pytest.mark.parametrize("workload,fault,expect", [
    ("controlnet.train", "unchanged_state", "change_err"),
    ("controlnet.train", "altered_answer", "loss_err"),
    ("controlnet.train", "last_only", "grad_err"),
    ("controlnet.train", "no_reset", "grad_err"),
    ("box2video.serve", "unchanged_state", "step_err"),
    ("box2video.serve", "half_batch", "step_err"),
    ("box2video.serve", "altered_answer", "decode_err"),
    ("box2video.serve", "uncond_as_cond", "clip_err"),
    ("box2video.serve", "wrong_time_ids", "time_ids_err"),
    ("box2video.serve", "no_last_step", "step_err"),
    ("bbox.predict5", "unchanged_state", "step_err"),
    ("bbox.predict5", "half_batch", "step_err"),
    ("bbox.predict5", "altered_answer", "decode_err"),
    ("bbox.predict5", "altered_choice", "select_mismatch"),
    ("bbox.predict5", "uncond_as_cond", "encode_err"),
    ("bbox.predict5", "no_last_step", "step_err"),
])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, workload, fault, expect):
    from benchmark import faults

    faults.plant(fault, TINY_KIND[workload], monkeypatch.setattr)
    result, _, _ = run_tiny(tiny_root, workload)
    assert result["correct"] is False
    failed = {n for n, c in result["checks"].items() if c["value"] > c["limit"]}
    assert expect in failed


def test_a_fault_planted_by_the_run_is_caught(tiny_root, monkeypatch):
    """``--fault`` plants for the rest of the process: pytest's monkeypatch
    puts the program back afterwards."""
    from benchmark import faults

    monkeypatch.setattr(faults, "plant", lambda name, kind: faults.FAULTS[name][1](
        monkeypatch.setattr, kind))
    result, _, _ = run_tiny(tiny_root, "controlnet.train", argv=["--fault", "last_only"])
    assert result["correct"] is False and result["checks"]["grad_err"]["value"] > 0.1


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted((REPO / "benchmark" / "reference").glob("*.py"))
                         + [REPO / "benchmark" / "yardstick.py", REPO / "benchmark" / "traffic.py"],
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    roots = {name.split(".")[0] for name in _imports(path)}
    assert not roots & {"ctrlv_tpu_torch", "ctrlv_tpu", "jax", "jaxlib", "flax"}


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.svd, benchmark.reference.sampling,"
            " benchmark.reference.weights, benchmark.yardstick, benchmark.traffic;"
            " print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'ctrlv_tpu_torch', 'ctrlv_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
