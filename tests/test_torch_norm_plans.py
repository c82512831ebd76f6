"""The launch plans of K4 (GroupNorm) and K5 (LayerNorm), on the CPU.

A plan is a pure function of the shape, so these tests need no card: for
every shape ``chip_smoke.py`` runs the kernels at and for ragged ones, each
plan fits the card's shared memory (at most 232,448 bytes a block, the
cluster's share included), covers every row or run exactly once, uses a
cluster of at most 16 CTAs, and asks the C entry for nothing it refuses (the
constants and the instantiations of ``csrc/*.cu`` are read from the source).
Runs beyond a cluster take the two-pass path.
"""

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke
from ctrlv_tpu_torch.ops import _build, _launch, group_norm, layer_norm
from ctrlv_tpu_torch.tools import ab_norms

CSRC = Path(__file__).resolve().parents[1] / "ctrlv_tpu_torch" / "csrc"
SMEM_BLOCK = 232_448

LN_SHAPES = sorted({spec["shape"] for kind, spec, _ in chip_smoke.KERNEL_CASES
                    if kind == "layer_norm"}
                   | {(257, 1280), (3, 1001, 8), (999, 1288), (33, 2048), (5, 72), (7, 200),
                      (1, 8), (2, 2048)})
GN_CASES = sorted({(spec["shape"], spec.get("groups", 32)) for kind, spec, _ in
                   chip_smoke.KERNEL_CASES if kind == "group_norm"}
                  | {((2, 33, 7, 9), 3), ((2, 6, 251, 163), 2), ((1, 2, 1_100_003), 2),
                     ((4, 512, 2560), 32), ((1, 128, 3, 320, 512), 32), ((2, 64, 24, 8), 2),
                     ((3, 2560, 5, 8), 32), ((1, 320, 25, 40, 64), 32), ((2, 32, 8), 32)})


def _constexpr(source: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert m, f"{name} not in {source}"
    return int(m.group(1))


def _ln_cases():
    text = (CSRC / "layer_norm.cu").read_text()
    return {(int(a), int(b)) for a, b in re.findall(r"CTRLV_LN_CASE\((\d+), (\d+)\)\n", text)}


def _rows(shape):
    return int(np.prod(shape[:-1]))


@pytest.mark.parametrize("shape", LN_SHAPES, ids=str)
def test_layer_norm_plan(shape):
    rows, c = _rows(shape), shape[-1]
    assert layer_norm.layer_norm_supported(shape, layer_norm.torch.bfloat16,
                                           layer_norm.torch.bfloat16)
    p = layer_norm._plan(rows, c)
    nvec = c // 8
    assert (p.lanes, p.vecs) in _ln_cases()  # the C entry has this instantiation
    assert p.lanes & (p.lanes - 1) == 0 and p.lanes * p.rows_per_warp == 32
    assert p.lanes * p.vecs >= nvec > p.lanes * (p.vecs - 1)  # no lane idle for a whole slot
    if c in (320, 640, 1280):
        assert (p.vecs, p.lanes * p.vecs) == (5, nvec)  # every lane loaded
    assert 1 <= p.blocks <= layer_norm.SMS * layer_norm.CTAS_PER_SM
    # the warps walk groups of rows_per_warp rows in a stride of the grid's warps
    warps = p.blocks * _constexpr("layer_norm.cu", "kWarps")
    groups = -(-rows // p.rows_per_warp)
    assert warps <= layer_norm.WARPS * -(-groups // layer_norm.WARPS)  # no block without rows
    taken = np.zeros(rows, np.int64)
    for w in range(min(warps, groups)):
        for g in range(w, groups, warps):
            taken[g * p.rows_per_warp:min(rows, (g + 1) * p.rows_per_warp)] += 1
    assert (taken == 1).all()


def test_layer_norm_constants_mirror_the_source():
    assert layer_norm.WARPS == _constexpr("layer_norm.cu", "kWarps")
    widths = range(8, layer_norm._MAX_WIDTH + 1, 8)
    assert {(layer_norm._plan(1, c).lanes, layer_norm._plan(1, c).vecs) for c in widths} \
        == _ln_cases()  # every instantiation is used, none is missing


def _slice_of(run, splits, sl):
    """csrc/group_norm.cu::slice_of."""
    per = (-(-run // splits) + 7) // 8 * 8
    start = per * sl
    hi = min(start + per, run)
    return min(start, hi), hi


def _check_plan(p, shape, groups):
    runs, run, spatial, cpg = group_norm._dims(shape, groups)
    if p.path == "short":
        k, stages = p.n, p.stages
        assert k in (1, 2, 4, 8) and 1 <= stages <= _constexpr("group_norm.cu", "kMaxStages")
        need = (group_norm.HEADER + group_norm._r128(8 * k * cpg)
                + stages * group_norm._r128(2 * k * run))
        assert p.smem == need <= SMEM_BLOCK
        items = -(-runs // k)
        assert 1 <= p.blocks <= min(items, group_norm.SMS * 4)
        taken = np.zeros(runs, np.int64)  # blocks walk items in a stride of the grid
        for b in range(p.blocks):
            for item in range(b, items, p.blocks):
                taken[item * k:min(runs, (item + 1) * k)] += 1
        assert (taken == 1).all()
    elif p.path == "cluster":
        cs = p.n
        assert 1 <= cs <= _constexpr("group_norm.cu", "kMaxCluster")
        slice_ = group_norm.cluster_slice(run, cs)
        assert slice_ % 8 == 0 and slice_ <= group_norm.MAX_CHUNKS * group_norm.CHUNK
        assert p.smem == (group_norm.HEADER + group_norm._r128(8 * cpg)
                          + group_norm._r128(2 * slice_)) <= SMEM_BLOCK
        sizes = [max(0, min(run, (r + 1) * slice_) - r * slice_) for r in range(cs)]
        assert sum(sizes) == run and p.blocks == runs * cs < 2**31
    else:
        assert p.path == "two_pass" and 1 <= p.n <= group_norm.MAX_SPLITS
        bounds = [_slice_of(run, p.n, s) for s in range(p.n)]
        assert bounds[0][0] == 0 and bounds[-1][1] == run
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert 1 <= p.ctas_per_sm and (p.smem + group_norm.SMEM_RESERVED) * p.ctas_per_sm \
        <= group_norm.SMEM_SM


@pytest.mark.parametrize("shape,groups", GN_CASES, ids=str)
def test_group_norm_plan(shape, groups):
    runs, run, spatial, cpg = group_norm._dims(shape, groups)
    p = group_norm._plan(tuple(shape), groups)
    _check_plan(p, shape, groups)
    aligned = run % 8 == 0 and spatial % 8 == 0
    if not aligned:
        assert p.path == "two_pass"
    elif 2 * group_norm._r128(2 * run) + group_norm.HEADER + group_norm._r128(8 * cpg) \
            <= group_norm.SMEM_SM // 2 - group_norm.SMEM_RESERVED:
        assert p.path == "short"  # two runs fit a block at 2 blocks an SM
    elif group_norm.cluster_plan(runs, run, spatial, cpg, cs=16) is not None:
        assert p.path == "cluster"
        slice_ = group_norm.cluster_slice(run, p.n)
        assert slice_ <= group_norm.CLUSTER_SLICE or p.n == 16
        assert p.n == 1 or group_norm.cluster_slice(run, p.n // 2) > group_norm.CLUSTER_SLICE
    else:
        assert p.path == "two_pass"  # beyond a cluster of 16
    for path in group_norm.PATHS:  # every path, forced, where it can take the shape
        forced = group_norm.plan_for(path, shape, groups)
        if forced is not None:
            assert forced.path == path
            _check_plan(forced, shape, groups)
            if path == "cluster":
                assert forced.n >= 2  # so that the CTAs add each other's sums
        else:
            assert path != "two_pass"
    for name, plan in ab_norms._k4_variants(shape, groups).items():
        _check_plan(plan, shape, groups)


@pytest.mark.parametrize("shape,path", [
    ((50, 320, 40, 64), "short"), ((50, 2560, 5, 8), "short"), ((25, 320, 40, 64), "short"),
    ((2, 320, 25, 40, 64), "cluster"), ((120, 128, 320, 512), "cluster"),
    ((2, 1280, 25, 5, 8), "cluster"), ((4, 512, 2560), "cluster"),
    ((1, 128, 320, 512), "cluster"), ((15, 128, 8, 320, 512), "two_pass"),
    ((2, 33, 7, 9), "two_pass"),
], ids=str)
def test_group_norm_paths_of_the_model_shapes(shape, path):
    groups = 3 if shape == (2, 33, 7, 9) else 32
    assert group_norm._plan(shape, groups).path == path


def test_group_norm_constants_mirror_the_source():
    src = "group_norm.cu"
    assert group_norm.HEADER == _constexpr(src, "kHeader")
    assert group_norm.THREADS == _constexpr(src, "kThreads")
    assert group_norm.SPLIT_THREADS == _constexpr(src, "kSplitThreads")
    assert group_norm.MAX_STAGES == _constexpr(src, "kMaxStages")
    assert group_norm.CHUNK == _constexpr(src, "kChunk")
    assert group_norm.MAX_CHUNKS == _constexpr(src, "kMaxChunks")
    assert group_norm.MAX_CLUSTER == _constexpr(src, "kMaxCluster")
    text = (CSRC / src).read_text()
    assert "enum Path { kShort = 0, kCluster = 1, kTwoPass = 2 };" in text
    assert group_norm.PATHS == ("short", "cluster", "two_pass")


def test_forcing_a_path_restores_the_plan():
    keep = group_norm._plan
    with chip_smoke.forced_k4_path("two_pass"):
        assert group_norm._plan((50, 320, 40, 64), 32).path == "two_pass"
        # a path that cannot take the shape leaves the shape its own plan
    with chip_smoke.forced_k4_path("short"):
        assert group_norm._plan((2, 320, 25, 40, 64), 32).path == "cluster"
    assert group_norm._plan is keep


def test_c_functions_resolve_once_per_library(monkeypatch):
    """The launch path looks a C entry point up once for each library in use."""
    first, second = SimpleNamespace(f="first"), SimpleNamespace(f="second")
    monkeypatch.setattr(_build, "_lib", first)
    assert _launch.c_function("f") == "first"
    first.f = "changed"
    assert _launch.c_function("f") == "first"  # resolved once
    monkeypatch.setattr(_build, "_lib", second)
    assert _launch.c_function("f") == "second"  # a new library resolves anew
