"""The port's measurement tools on the CPU: the FLOP counts
(``ctrlv_tpu_torch.tools.flops``), ``tools.bench``, ``tools.bench_train`` and
``tools.profile_denoise``.

- Full-width FLOPs on ``meta`` under the kernels' plain versions: the
  ControlNet and the UNet a CFG denoise step at 2 x 25 frames of 40x64
  latents, a decode of an 8-frame chunk and a whole Box2Video clip, each
  pinned to 0.1 %, and the first three within 5 % of the XLA counts of the
  JAX package's ``tools/flops_report.py`` (BASELINE.md: 13.57, 37.43, 14.89
  TFLOP), which count elementwise work too.
- ``tools.bench --tiny --device cpu --workload overall``: both lines in
  ``bench.py``'s form, ``value`` the median of the runs, the FLOPs those of
  ``tools.flops`` at the same sizes; no device number where there is no card.
- ``tools.bench_train --tiny --device cpu --regime all``: a line a regime,
  each one's trainable parameter count that of the JAX package's own subset
  functions (``split_trainable`` with ``temporal_blocks_predicate``,
  ``lora_init``) at the same config; a failed regime gives an error line and a
  non-zero exit.
- ``tools.profile_denoise --tiny --device cpu``: the rows by op sum to the
  total, the kinds too.
- Without ``--device`` the tools run on the card and raise where there is none.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ctrlv_tpu.models import ControlNetSpatioTemporal as JaxControlNet
from ctrlv_tpu.models import UNetSpatioTemporalConditionModel as JaxUNet
from ctrlv_tpu.models import UNetSTConfig as JaxUNetSTConfig
from ctrlv_tpu.train import lora as jax_lora
from ctrlv_tpu.train.state import split_trainable as jax_split_trainable
from ctrlv_tpu.train.state import temporal_blocks_predicate as jax_temporal_predicate
from ctrlv_tpu_torch.tools import bench, bench_train, flops, profile_denoise

# TFLOP at the SVD-XT widths: (tools.flops, pinned to 0.1 %; XLA's count, BASELINE.md)
STEP_TFLOP = {"controlnet": (13.138, 13.57), "unet": (36.592, 37.43)}
DECODE8_TFLOP = (15.150, 14.89)
PIN, XLA_TOL = 1e-3, 0.05


def close(got, want, rel):
    return abs(got - want) <= rel * want


@pytest.fixture(scope="module")
def full_width():
    models = flops.counting_models()
    return models, flops.box2video_flops(models)


@pytest.mark.parametrize("net", ["controlnet", "unet"])
def test_denoise_step_flops_at_full_width(full_width, net):
    _, clip = full_width
    tflop = clip[net] / 25 / 1e12  # 25 steps, each at CFG batch 2 x 25 frames of 40x64
    pinned, xla = STEP_TFLOP[net]
    assert close(tflop, pinned, PIN), tflop
    assert close(tflop, xla, XLA_TOL), (tflop, xla)


def test_decode_chunk_flops_at_full_width(full_width):
    models, clip = full_width
    tflop = flops.vae_decode_flops(models["vae"], 1, 8, 40, 64, 8) / 1e12
    assert close(tflop, DECODE8_TFLOP[0], PIN), tflop
    assert close(tflop, DECODE8_TFLOP[1], XLA_TOL), tflop
    # the clip's decode: chunks 8 + 8 + 8 in one call, then 1
    one = flops.vae_decode_flops(models["vae"], 1, 1, 40, 64, 1)
    assert clip["vae_decode"] == flops.vae_decode_flops(models["vae"], 1, 24, 40, 64, 8) + one


def test_clip_flops_at_full_width(full_width):
    _, clip = full_width
    tflop = clip["total"] / 1e12
    assert close(tflop, chip_smoke.CLIP_TFLOP, PIN), tflop
    assert chip_smoke.CLIP_TFLOP_TOL == PIN
    assert clip["total"] == sum(v for k, v in clip.items() if k != "total")
    # bench.py's 25 steps x (UNet + ControlNet) + decode + encodes + CLIP, BASELINE.md's ~1,350
    assert close(tflop, 1350.0, XLA_TOL)


def _lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]


def test_bench_tiny_on_the_cpu(capsys):
    lines = bench.main(["--tiny", "--device", "cpu", "--runs", "2", "--workload", "overall"])
    assert _lines(capsys) == json.loads(json.dumps(lines))
    clip, request = lines
    size = bench.TINY_SIZE
    assert clip["metric"] == "box2video_3f_16x16_sec_per_clip" and clip["unit"] == "s/clip"
    assert request["metric"] == "overall_request_3f_16x16_sec_per_request"
    assert request["unit"] == "s/request" and request["vs_baseline"] is None
    assert clip["vs_baseline"] is None  # the A100 estimate is for the full size
    for line, runs in ((clip, 2), (request, 1)):
        d = line["detail"]
        assert set(line) == {"metric", "value", "unit", "vs_baseline", "detail"}
        assert len(d["times_s"]) == d["runs"] == runs
        assert line["value"] == float(np.median(d["times_s"]))
        assert all(t > 0 for t in d["times_s"]) and d["init_s"] > 0
        assert d["device"] == "cpu" and d["config"] == "tiny"
        # no device number from a CPU run
        assert d["mfu"] is None and d["peak_gib"] is None and d["build_s"] is None
        assert set(d["launches"]) == set(bench._launch.LAUNCHES)
        assert not any(d["launches"].values())  # the CPU takes the plain versions
    d = clip["detail"]
    assert d["steps"] == size["steps"] and d["warmup_s"] > 0
    assert d["min_s"] == min(d["times_s"])
    assert d["spread"] == (max(d["times_s"]) - min(d["times_s"])) / clip["value"]
    assert d["temporal_layout"] == "seq"
    models = flops.counting_models(tiny=True, stage1=True, device="cpu")
    fsize = dict(frames=3, height=16, width=16, chunk=2)
    assert d["tflop_per_clip"] == flops.box2video_flops(models, steps=2, **fsize)["total"] / 1e12
    r = request["detail"]
    assert r["tflop_per_request"] == flops.overall_flops(
        models, stage1_steps=2, stage2_steps=2, **fsize)["total"] / 1e12
    assert r["stage1_s"] > 0 and r["stage2_s"] > 0
    assert r["stage1_s"] + r["stage2_s"] + r["select_s"] == pytest.approx(request["value"])
    assert r["candidates"] == 5 and tuple(r["best_guidance"]) in bench.GUIDANCE_PAIRS


def _jax_counts():
    """Trainable parameters of each regime in the JAX package at the same config."""
    cfg = JaxUNetSTConfig.micro(num_frames=3)
    sample = jnp.zeros((1, 3, 8, 8, cfg.in_channels))
    args = (sample, jnp.ones(()), jnp.zeros((1, 1, cfg.cross_attention_dim)), jnp.zeros((1, 3)))
    cond = jnp.zeros((1, 3, 8, 8, cfg.in_channels // 2))
    key = jax.random.PRNGKey(0)
    unet = jax.eval_shape(lambda: JaxUNet(config=cfg).init(key, *args))
    ctrl = jax.eval_shape(lambda: JaxControlNet(config=cfg).init(key, *args, cond))
    lora = jax.eval_shape(lambda p: jax_lora.lora_init(key, p, rank=4), unet["params"])
    size = lambda tree: sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree))  # noqa: E731
    temporal = size(jax_split_trainable(unet, jax_temporal_predicate))
    return {"controlnet": size(ctrl["params"]), "temporal": temporal, "lora": size(lora),
            "full": size(unet["params"])}


def test_bench_train_tiny_on_the_cpu(capsys):
    lines = bench_train.main(["--tiny", "--device", "cpu", "--regime", "all", "--accum", "2",
                              "--measure_steps", "1"])
    assert _lines(capsys) == json.loads(json.dumps(lines))
    assert [line["regime"] for line in lines] == list(bench_train.REGIMES)
    want = _jax_counts()
    tflop = {}
    for line in lines:
        assert "error" not in line, line
        kind = bench_train.REGIMES[line["regime"]][0]
        assert line["trainable_params_m"] == want[kind] / 1e6, (line["regime"], want[kind])
        assert line["accum"] == 2 and len(line["micro_steps_s"]) == 2
        assert line["sec_per_micro_step"] == line["micro_steps_s"][0]
        assert line["sec_per_opt_step"] == pytest.approx(sum(line["micro_steps_s"]))
        assert line["update_micro_step_s"] == line["micro_steps_s"][1]
        assert np.isfinite(line["loss_first_step"]) and line["loss_first_step"] > 0
        assert line["mfu"] is None and line["peak_gib"] is None and line["device"] == "cpu"
        assert line["f32_masters"] is False and line["remat"] == "block"
        assert line["tflop_per_micro_step"] > 0
        tflop.setdefault(kind, set()).add(line["tflop_per_micro_step"])
    assert all(len(v) == 1 for v in tflop.values())  # one count a kind of micro-step


def test_bench_train_reports_a_failed_regime_and_exits_non_zero(monkeypatch, capsys):
    monkeypatch.setattr(flops, "train_micro_step_flops", lambda *a, **k: 1.0)
    real = bench_train.bench_regime

    def failing(models, regime, *args):
        if regime == "lora":
            raise torch.cuda.OutOfMemoryError("probe")
        return real(models, regime, *args)

    monkeypatch.setattr(bench_train, "bench_regime", failing)
    argv = ["--tiny", "--device", "cpu", "--regime", "lora,temporal", "--accum", "1",
            "--measure_steps", "1"]
    assert bench_train.cli(argv) == 1
    lora, temporal = _lines(capsys)
    assert lora == {"regime": "lora", "error": "OutOfMemoryError: probe"}
    assert "error" not in temporal and temporal["regime"] == "temporal"
    assert temporal["sec_per_opt_step"] == temporal["sec_per_micro_step"]  # accum 1


def test_profile_denoise_tiny_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "pools.json"
    summary = profile_denoise.main(["--tiny", "--device", "cpu", "--steps", "1", "--top", "5",
                                    "--out", str(out)])
    printed = _lines(capsys)
    assert len(printed) == 1 and printed[0]["ms_per_step"] == summary["ms_per_step"]
    with open(out) as fh:
        written = json.load(fh)
    rows = written["by_op"]
    assert summary["clock"] == written["clock"] == "cpu"  # no device time on the CPU
    assert len(printed[0]["top"]) == 5 and printed[0]["top"] == rows[:5]
    total = summary["ms_per_step"]
    assert total > 0
    assert sum(r["ms"] for r in rows) == pytest.approx(total, rel=1e-9)
    assert sum(r["share"] for r in rows) == pytest.approx(1.0, rel=1e-9)
    assert sum(summary["by_kind"].values()) == pytest.approx(total, rel=1e-9)
    assert [r["ms"] for r in rows] == sorted((r["ms"] for r in rows), reverse=True)
    assert any(r["name"] == "aten::mkldnn_convolution" or "conv" in r["name"] for r in rows)


@pytest.mark.parametrize("tool", [bench, bench_train, profile_denoise])
def test_tools_run_on_the_card_unless_told(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--tiny"])
