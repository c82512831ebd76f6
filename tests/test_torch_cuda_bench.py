"""The measurement tools and the profiling helpers on the card.

These tests need an NVIDIA GPU and skip without one. On the card, from the
repository root (``--noconftest``: tests/conftest.py configures JAX, which a
GPU host of the port need not have; this file imports only torch and the
port):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_bench.py

- ``trace`` on the card records the kernels' device time, and ``StepTimer``
  fences each step (a step of queued work is timed at its device time, not at
  the host's time to enqueue it).
- ``tools.bench``, ``tools.bench_train`` and ``tools.profile_denoise`` at the
  small configs on the card: every device number present and finite, the MFU
  in (0, 1), the device time read on the card's clock and summing by op to the
  total.
"""

import json
import math

import pytest
import torch

from ctrlv_tpu_torch.tools import bench, bench_train, profile_denoise
from ctrlv_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_trace_and_step_timer_on_the_card(cuda, tmp_path):
    a = torch.randn(4096, 4096, device=cuda, dtype=torch.bfloat16)
    timer = profiling.StepTimer(warmup=1, device=cuda)
    with profiling.trace(str(tmp_path)) as prof:
        for _ in range(3):
            with profiling.annotate("matmuls"), timer:
                for _ in range(20):
                    a @ a
    table = profile_denoise.aggregate(prof, 3)
    assert table["clock"] == "cuda" and table["total_ms"] > 0
    assert sum(r["ms"] for r in table["by_op"]) == pytest.approx(table["total_ms"], rel=1e-9)
    # 20 products of 2 * 4096^3 FLOP each, a step: the timer reads the device's work
    # (at most the bf16 peak), not the host's enqueue
    assert min(timer.times) >= 20 * 2 * 4096**3 / 989e12
    assert len(list(tmp_path.glob("*.json"))) == 1


def _finite(value):
    """Every number in ``value`` is finite (strings, flags and None pass)."""
    if isinstance(value, dict):
        return all(_finite(v) for v in value.values())
    if isinstance(value, list):
        return all(_finite(v) for v in value)
    return not isinstance(value, float) or math.isfinite(value)


def test_bench_on_the_card(cuda, capsys):
    lines = bench.main(["--tiny", "--runs", "2", "--workload", "overall"])
    assert [json.loads(x) for x in capsys.readouterr().out.splitlines()] == lines
    for line in lines:
        d = line["detail"]
        assert _finite(d), d
        assert 0 < d["mfu"] < 1 and d["peak_gib"] > 0 and d["build_s"] >= 0
        assert d["device"] != "cpu" and sum(d["launches"].values()) > 0


def test_bench_train_on_the_card(cuda):
    lines = bench_train.main(["--tiny", "--regime", "controlnet,lora", "--accum", "2",
                              "--measure_steps", "1"])
    for line in lines:
        assert "error" not in line, line
        assert _finite(line) and 0 < line["mfu"] < 1 and line["peak_gib"] > 0


def test_profile_denoise_on_the_card(cuda):
    summary = profile_denoise.main(["--tiny", "--steps", "2", "--top", "5"])
    assert summary["clock"] == "cuda" and summary["ms_per_step"] > 0
    total = sum(r["ms"] for r in summary["by_op"])
    assert total == pytest.approx(summary["ms_per_step"], rel=1e-9)
