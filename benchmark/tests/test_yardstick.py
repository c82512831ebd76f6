"""The benchmark's own arithmetic: the FLOP counts pinned at full size, the
least time of one feed-forward and one attention call, the idle share and
the span attribution of a synthetic trace."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import trace, yardstick
from benchmark.cells import bbox_predict, box2video, controlnet_train
from benchmark.reference import svd
from conftest import REPO


def full_cell(module, config, traffic):
    cfg = json.loads((REPO / "benchmark/configs" / f"{config}.json").read_text())
    tr = json.loads((REPO / "benchmark/traffic" / f"{traffic}.json").read_text())
    return module.Cell(cfg, tr, 1, "cpu")


# TFLOP of one request at full size. Box2Video equals the program's own count
# (ctrlv_tpu_torch/tools/flops.py, 1,308.882). Stage 1 is 6.456 above that
# tool's (7,119.357 for the overall request less its stage 2): the reference
# computes the temporal one-token cross-attention's projections once a pixel,
# as the published "seq" form does, the program's frames-major layout once a
# frame. A ControlNet micro-step, its block checkpointing's recompute
# counted, equals that tool's 103.19.
@pytest.mark.parametrize("module,config,traffic,tflop", [
    (box2video, "svd-xt-box2video", "box2video.serve", 1308.882),
    (bbox_predict, "svd-xt-bbox-predictor", "bbox.predict5", 5816.931),
    (controlnet_train, "svd-xt-box2video", "controlnet.train", 103.188),
])
def test_flops_of_a_request_are_pinned(module, config, traffic, tflop):
    flops, sites = full_cell(module, config, traffic).work()
    assert flops / 1e12 == pytest.approx(tflop, abs=0.001)
    assert {s.kind for s in sites} == {"attention", "feed_forward"}


def test_implied_v_inverts_the_euler_step():
    from benchmark.reference import sampling

    g = torch.Generator().manual_seed(1)
    sig = sampling.karras_sigmas(25)
    x, v = torch.randn(2, 3, 4, 4, 4, generator=g), torch.randn(2, 3, 4, 4, 4, generator=g)
    for s in (0, 12, 23):
        x_s = x * torch.sqrt(sig[s] ** 2 + 1.0)
        x_next = sampling.euler_step(v, x_s, sig[s], sig[s + 1])
        implied = sampling.implied_v(x_s, x_next, sig[s], sig[s + 1])
        assert (implied - v).abs().max() < 1e-3 * (1 + float(sig[s]))


def test_feed_forward_site_by_hand():
    ff = svd.FeedForward(320)
    site = yardstick.feed_forward_site(ff, (2, 25 * 2560, 320), 2)
    m, c, inner = 2 * 25 * 2560, 320, 1280
    assert site.flops == 2 * m * c * 2 * inner + 2 * m * inner * c  # 24 M C^2
    assert site.flops == 24 * m * c * c
    assert site.bytes == 2 * (2 * m * c + c * 2 * inner + 2 * inner + inner * c + c)
    assert site.least_s() == pytest.approx(site.flops / 989e12)  # compute-bound


def test_attention_sites_by_hand():
    attn = svd.Attention(320, 5, 64)
    b, s, c = 50, 2560, 320
    site = yardstick.attention_site(attn, (b, s, c), None, 2, 2)
    assert site.flops == 2 * b * (4 * s * c * 320 + 2 * s * s * 320)
    weights = 4 * c * 320 + c
    assert site.bytes == 2 * (2 * b * s * c + weights)
    temporal = yardstick.attention_site(attn, (b * s // 25, 25, c), None, 2, 2)
    assert temporal.flops == 2 * b * s * (4 * c * 320 + 2 * 25 * 320)
    assert temporal.least_s() == max(temporal.flops / 989e12, temporal.bytes / 3.35e12)
    cross = svd.Attention(320, 5, 64, cross_attention_dim=1024)
    one = yardstick.attention_site(cross, (b, s, c), (b, 1, 1024), 2, 2)
    assert one.flops == 2 * 2 * (1024 * 320 + 320 * 320)  # two distinct CLIP tokens


class _Event:
    def __init__(self, name, kind, start_us, dur_us, corr=0, device=False):
        self._v = (name, kind, int(start_us * 1000), int(dur_us * 1000), corr, device)

    def name(self):
        return self._v[0]

    def activity_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def device_type(self):
        dt = torch.autograd.DeviceType
        return dt.CUDA if self._v[5] else dt.CPU


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {
            "events": staticmethod(lambda: events)})})


def synthetic_trace():
    """A unit from 0 to 100 us: a FeedForward span (10-30) launching a kernel
    that runs 20-40, a kernel outside it running 50-60, idle elsewhere."""
    ev = [
        _Event("bench.unit", "user_annotation", 0, 100),
        _Event("bench.feed_forward", "user_annotation", 10, 20),
        _Event("cudaLaunchKernel", "cuda_runtime", 12, 2, corr=1),
        _Event("cudaLaunchKernel", "cuda_runtime", 45, 2, corr=2),
        _Event("geglu_ff_kernel", "kernel", 20, 20, corr=1, device=True),
        _Event("elementwise_kernel", "kernel", 50, 10, corr=2, device=True),
        _Event("aten::item", "cpu_op", 60, 40),
    ]
    return trace.Trace(_Prof(ev))


def test_idle_share_and_attribution_of_a_synthetic_trace():
    t = synthetic_trace()
    lo, hi = t.window()
    assert (lo, hi) == pytest.approx((0.0, 100e-6))
    assert t.busy_s(lo, hi) == pytest.approx(30e-6)
    assert t.device_s("feed_forward") == pytest.approx(20e-6)
    assert t.device_s() == pytest.approx(30e-6)
    assert t.covered_s(("feed_forward",)) == pytest.approx(20e-6)
    gaps = dict((k, v) for k, v in t.idle_gaps(lo, hi))
    assert sum(gaps.values()) == pytest.approx(70e-6)
    assert gaps["waits for elementwise (adds, muls, gelu, SiLU)"] == pytest.approx(10e-6)
    assert gaps["waits for the unit's end"] == pytest.approx(40e-6)


def entry(name: str) -> dict:
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    return next(m for m in spec["per_layer"] if m["name"] == name)


def test_idle_pct_reader_on_a_synthetic_trace():
    from benchmark.run import Window, reader

    w = Window("x", None, {})
    w.trace = synthetic_trace()
    assert reader(REPO, entry("idle_pct.box2video")).read(w) == pytest.approx(70.0)
    w.traced_units = 1
    assert reader(REPO, entry("outside_denoise_s.box2video")).read(w) is None  # no denoise span
