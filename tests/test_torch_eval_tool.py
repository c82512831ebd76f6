"""The port's overall-eval entry point against the JAX package's tool.

``tools/eval_overall.py`` (JAX) and ``ctrlv_tpu_torch.tools.eval_overall``
run their loops over the same synthetic dataset with ``OverallPipeline``
replaced by a recorder, so that nothing samples: for two samples the first
frame, the bbox frames and every keyword that reaches the pipeline are equal
(the JAX side's model building is stubbed out too; it only records). Then
one real run of the port's tool on the CPU at the tiny config, and the rule
that the tool runs on the card unless told otherwise.
"""

import os

import numpy as np
import pytest
import torch

from ctrlv_tpu_torch.pipelines import OverallPipeline
from ctrlv_tpu_torch.tools import eval_overall
from ctrlv_tpu_torch.utils.config import Config as PortConfig
from ctrlv_tpu_torch.utils.config import parse_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORES = ("miou", "ap", "ar", "miou_first_last", "ap_first_last", "ar_first_last")

torch.set_num_threads(1)


def _config(cls, tmp_path, train_W=24, **kw):
    return cls(dataset_name="synthetic", data_root=str(tmp_path), clip_length=3, train_H=16,
               train_W=train_W, num_inference_steps=2, decode_chunk_size=2, num_demo_samples=2,
               fps=5, seed=3, output_dir=str(tmp_path / "out"), **kw)


def _fake_result(num_frames, h, w):
    frames = np.zeros((num_frames, h, w, 3), np.float32)
    return dict(video=frames, bbox_video=frames, best_guidance=(1.0, 2.0),
                **{k: 0.25 for k in SCORES})


@pytest.fixture
def jax_tool(monkeypatch):
    """The JAX tool's module, imported with the JAX settings its ``common``
    module changes put back afterwards."""
    import jax

    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_entry_size_bytes",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    monkeypatch.syspath_prepend(os.path.join(REPO, "tools"))
    try:
        import eval_overall as tool
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return tool


def test_the_pipeline_gets_what_the_jax_tool_gives(jax_tool, monkeypatch, tmp_path):
    from ctrlv_tpu.utils.config import Config as JaxConfig

    calls = {"jax": [], "port": []}

    class JaxRecorder:
        def __init__(self, *args):
            pass

        def __call__(self, image, bbox, rng, **kw):
            calls["jax"].append((np.asarray(image), np.asarray(bbox), kw))
            return _fake_result(kw["num_frames"], *np.shape(image)[:2])

    def port_call(self, image, bbox, generator=None, **kw):
        assert isinstance(generator, torch.Generator)
        calls["port"].append((image.numpy(), bbox.numpy(), kw))
        return _fake_result(kw["num_frames"], *image.shape[:2])

    monkeypatch.setattr(jax_tool, "build_models", lambda cfg, **kw: dict.fromkeys(
        ("unet", "unet_params", "vae", "vae_params", "clip", "clip_params", "ctrl",
         "ctrl_params")))
    for name in ("VideoDiffusionPipeline", "StableVideoControlPipeline"):
        monkeypatch.setattr(jax_tool, name, lambda *a, **k: None)
    monkeypatch.setattr(jax_tool, "OverallPipeline", JaxRecorder)
    monkeypatch.setattr(OverallPipeline, "__call__", port_call)

    ref = jax_tool.main(_config(JaxConfig, tmp_path / "jax"), max_samples=5)
    out = eval_overall.main(_config(PortConfig, tmp_path / "port", device="cpu"), max_samples=5)
    assert len(calls["jax"]) == len(calls["port"]) == 2  # num_demo_samples
    for (img, bbox, kw), (img_r, bbox_r, kw_r) in zip(calls["port"], calls["jax"]):
        np.testing.assert_array_equal(img, img_r)
        np.testing.assert_array_equal(bbox, bbox_r)
        assert kw == kw_r
    assert not np.array_equal(calls["port"][0][1], calls["port"][1][1])  # two clips
    assert out == ref
    for i in range(2):
        for name in (f"generated_video_{i}.gif", f"predicted_bbox_{i}.gif"):
            assert (tmp_path / "port" / "out" / name).exists()


def test_tiny_run_on_the_cpu(tmp_path):
    """One real sample through the tiny models: 30 + 2 steps at 16x16."""
    cfg = _config(PortConfig, tmp_path, train_W=16, device="cpu", mixed_precision="no")
    summary = eval_overall.main(cfg, max_samples=1)
    assert sorted(summary) == sorted(SCORES)
    for mean, std in summary.values():
        assert np.isfinite(mean) and 0.0 <= mean <= 1.0 and std == 0.0
    from ctrlv_tpu_torch.utils.video_io import load_video

    for name in ("generated_video_0.gif", "predicted_bbox_0.gif"):
        video = load_video(str(tmp_path / "out" / name))
        assert video.shape[1:] == (16, 16, 3), name


def test_the_tool_runs_on_the_card_unless_told(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_overall.main(_config(PortConfig, tmp_path))
    assert parse_args([]).device is None and parse_args(["--device", "cpu"]).device == "cpu"


def test_more_than_one_card_is_not_ported(tmp_path):
    """A mesh above one rank needs the process group of torchrun: a lone
    process that asks for one raises and says so (tests/test_torch_dist_tools.py
    runs the tool on two ranks)."""
    with pytest.raises(RuntimeError, match="torchrun"):
        eval_overall.main(_config(PortConfig, tmp_path, device="cpu", mesh_data=2))


def test_image_metrics_match_jax():
    """SSIM and PSNR against the JAX package's, f32: the filter sums in
    another order, so to 1e-5."""
    import jax.numpy as jnp

    from ctrlv_tpu.metrics.image import psnr as jax_psnr
    from ctrlv_tpu.metrics.image import ssim as jax_ssim
    from ctrlv_tpu_torch.metrics import psnr, ssim

    rng = np.random.default_rng(9)
    a = rng.uniform(0, 1, (24, 20, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(float(ssim(ta, tb)), float(jax_ssim(jnp.asarray(a), jnp.asarray(b))),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(psnr(ta, tb)), float(jax_psnr(jnp.asarray(a), jnp.asarray(b))),
                               atol=1e-5, rtol=1e-5)
    assert float(ssim(ta, ta)) == pytest.approx(1.0, abs=1e-6)


def test_box2video_tool_tiny_run(tmp_path):
    """The teacher-forced Box2Video tool, one clip through the tiny models."""
    import pickle

    from ctrlv_tpu_torch.tools import eval_video_controlnet

    cfg = _config(PortConfig, tmp_path, train_W=16, device="cpu", mixed_precision="no")
    summary = eval_video_controlnet.main(cfg, max_samples=1)
    assert sorted(summary) == ["psnr", "ssim"] and all(np.isfinite(list(summary.values())))
    out = tmp_path / "out"
    for name in ("generated_video_0.gif", "gt_video_0.gif", "gt_labels_0.pkl"):
        assert (out / name).exists(), name
    with open(out / "gt_labels_0.pkl", "rb") as f:
        labels = pickle.load(f)
    assert labels["index"] == [0] and labels["objects"]["bbox"].shape == (1, 3, 30, 4)
