"""The port's stage-1 eval, generation eval and Box2Video eval commands
against the JAX package's tools.

``tools/eval_video_bbox_prediction.py``, ``tools/eval_video_generation.py`` and
``tools/eval_video_controlnet.py`` (JAX) and their counterparts in
``ctrlv_tpu_torch.tools`` run their loops over the same synthetic dataset with
the pipeline replaced by a recorder that hands both sides the same frames:
for two clips the first frame, the bbox frames and every keyword that reaches
the pipeline are equal, and so are the scores (exactly: numpy on both sides)
and the exported GIFs (byte for byte). The JAX side's model building is
stubbed out; the port's builds the tiny models. Then one real run of each
port tool on the CPU at the tiny config, and the rule that the tools run on
the card unless told otherwise.
"""

import os

import numpy as np
import pytest
import torch

from ctrlv_tpu_torch.pipelines import StableVideoControlPipeline, VideoDiffusionPipeline
from ctrlv_tpu_torch.tools import eval_video_bbox_prediction, eval_video_controlnet
from ctrlv_tpu_torch.tools import eval_video_generation
from ctrlv_tpu_torch.utils.config import Config as PortConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_TOOLS = {"eval_video_bbox_prediction": eval_video_bbox_prediction,
              "eval_video_generation": eval_video_generation,
              "eval_video_controlnet": eval_video_controlnet}
PIPELINES = {"eval_video_bbox_prediction": ("VideoDiffusionPipeline", VideoDiffusionPipeline),
             "eval_video_generation": ("VideoDiffusionPipeline", VideoDiffusionPipeline),
             "eval_video_controlnet": ("StableVideoControlPipeline", StableVideoControlPipeline)}
# what each tool exports a clip
EXPORTS = {"eval_video_bbox_prediction": ("pred_bbox_{}.gif",),
           "eval_video_generation": ("generated_videos_{}.gif", "gt_videos_{}.gif"),
           "eval_video_controlnet": ("generated_video_{}.gif", "gt_video_{}.gif")}

torch.set_num_threads(1)


def _config(cls, tmp_path, train_W=24, **kw):
    return cls(dataset_name="synthetic", data_root=str(tmp_path), clip_length=3, train_H=16,
               train_W=train_W, num_inference_steps=2, decode_chunk_size=2, num_demo_samples=2,
               fps=5, seed=3, output_dir=str(tmp_path / "out"), **kw)


def _handed_frames(image, bbox):
    """The frames both recorders return, made from what the pipeline got:
    the bbox frames shifted by a pixel and dimmed by the first frame's mean,
    so that IoU and boundary F are neither 0 nor 1."""
    if bbox is None:
        return np.clip(np.stack([np.asarray(image)[0]] * 3) / 2 + 0.6, 0, 1)[None]
    frames = np.clip(np.roll(np.asarray(bbox)[0], 1, axis=2) / 2 + 0.5, 0, 1)
    return (frames * (0.9 + 0.1 * float(np.abs(np.asarray(image)).mean())))[None]


@pytest.fixture
def jax_tool(monkeypatch):
    """A JAX tool's module by name, imported with the JAX settings its
    ``common`` module changes put back afterwards."""
    import importlib

    import jax

    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_entry_size_bytes",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    monkeypatch.syspath_prepend(os.path.join(REPO, "tools"))

    def load(name):
        try:
            return importlib.import_module(name)
        finally:
            for k, v in saved.items():
                jax.config.update(k, v)

    return load


@pytest.mark.parametrize("name", sorted(PORT_TOOLS))
def test_the_pipeline_gets_what_the_jax_tool_gives(name, jax_tool, monkeypatch, tmp_path):
    import jax.numpy as jnp

    from ctrlv_tpu.utils.config import Config as JaxConfig

    tool, port = jax_tool(name), PORT_TOOLS[name]
    calls = {"jax": [], "port": []}

    class JaxRecorder:
        def __init__(self, *args):
            pass

        def __call__(self, image, bbox=None, bbox_images=None, rng=None, **kw):
            bbox = bbox if bbox is not None else bbox_images
            calls["jax"].append((np.asarray(image), None if bbox is None else np.asarray(bbox), kw))
            return jnp.asarray(_handed_frames(image, bbox), jnp.float32)

    def port_call(self, image, bbox=None, bbox_images=None, generator=None, **kw):
        assert isinstance(generator, torch.Generator)
        bbox = bbox if bbox is not None else bbox_images
        calls["port"].append((image.numpy(), None if bbox is None else bbox.numpy(), kw))
        return torch.from_numpy(_handed_frames(image.numpy(), None if bbox is None
                                               else bbox.numpy()).astype(np.float32))

    monkeypatch.setattr(tool, "build_models", lambda cfg, **kw: dict.fromkeys(
        ("unet", "unet_params", "vae", "vae_params", "clip", "clip_params", "ctrl",
         "ctrl_params")))
    pipe_name, pipe_cls = PIPELINES[name]
    monkeypatch.setattr(tool, pipe_name, JaxRecorder)
    monkeypatch.setattr(pipe_cls, "__call__", port_call)

    ref = tool.main(_config(JaxConfig, tmp_path / "jax"), max_samples=2)
    out = port.main(_config(PortConfig, tmp_path / "port", device="cpu"), max_samples=2)
    assert len(calls["jax"]) == len(calls["port"]) == 2
    for (img, bbox, kw), (img_r, bbox_r, kw_r) in zip(calls["port"], calls["jax"]):
        np.testing.assert_array_equal(img, img_r)
        if bbox_r is None:
            assert bbox is None
        else:
            np.testing.assert_array_equal(bbox, bbox_r)
        assert kw == kw_r
    assert not np.array_equal(calls["port"][0][0], calls["port"][1][0])  # two clips
    if name == "eval_video_controlnet":  # SSIM and PSNR in torch against JAX, f32
        assert out.keys() == ref.keys() and all(out[k] == pytest.approx(ref[k], rel=1e-5)
                                                for k in ref)
    else:  # the scores on the handed frames, numpy on both sides (none for generation)
        assert out == ref
    if name == "eval_video_bbox_prediction":
        assert 0.0 < out["miou"] < 1.0 and 0.0 < out["f_measure"] < 1.0
    for i in range(2):
        for pattern in EXPORTS[name]:
            got = (tmp_path / "port" / "out" / pattern.format(i)).read_bytes()
            assert got == (tmp_path / "jax" / "out" / pattern.format(i)).read_bytes(), pattern


def test_stage1_scores_on_handed_frames():
    """The stage-1 tool's scoring against the JAX tool's arithmetic, on frames
    with speckle under the darkness threshold and boxes that only partly meet."""
    import jax.numpy as jnp

    from ctrlv_tpu.metrics import binary_mask_iou, stage1_frame_f_measure

    rng = np.random.default_rng(2)
    bbox = np.full((4, 40, 64, 3), -1.0, np.float32)
    gen = np.zeros((4, 40, 64, 3), np.float32)
    for f in range(4):
        bbox[f, 5 + f:25 + f, 10:12] = bbox[f, 5 + f:25 + f, 40:42] = 0.6
        bbox[f, 5 + f:7 + f, 10:42] = bbox[f, 23 + f:25 + f, 10:42] = 0.6
        gen[f, 6 + f:26 + f, 11:44] = rng.random((20, 33, 3)) * 0.5 + 0.3
    gen += (rng.random(gen.shape) < 0.1) * (4.0 / 255.0)
    got = eval_video_bbox_prediction.score_clip(gen, bbox)
    gt = np.asarray(jnp.clip(jnp.asarray(bbox) / 2 + 0.5, 0, 1))
    miou, _, _ = binary_mask_iou((gt * 255).astype(np.uint8), (gen * 255).astype(np.uint8))
    gt_u8 = (gt * 255.0).astype(np.uint8)
    fs = [stage1_frame_f_measure(gen[f], gt_u8[f]) for f in range(4)]
    assert got == {"miou": miou, "f_measure": float(np.mean(fs))}
    assert 0.0 < got["miou"] < 1.0 and 0.0 < got["f_measure"] < 1.0


def test_tiny_runs_on_the_cpu(tmp_path):
    """One real clip through each tool's tiny models at 16x16, with the FVD
    of the generation tool (its I3D at 224 pixels, seeded weights)."""
    from ctrlv_tpu_torch.utils.video_io import load_video

    kw = dict(train_W=16, device="cpu", mixed_precision="no")
    summary = eval_video_bbox_prediction.main(_config(PortConfig, tmp_path / "bbox", **kw),
                                              max_samples=1)
    assert sorted(summary) == ["f_measure", "miou"]
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in summary.values())
    fvd = eval_video_generation.main(_config(PortConfig, tmp_path / "gen", **kw), max_samples=1,
                                     compute_fvd=False)
    assert fvd is None
    for name, root in (("pred_bbox_0.gif", "bbox"), ("generated_videos_0.gif", "gen"),
                       ("gt_videos_0.gif", "gen")):
        assert load_video(str(tmp_path / root / "out" / name)).shape[1:] == (16, 16, 3), name


def test_generation_tool_fvd_on_the_cpu(tmp_path):
    """``evaluate(..., compute_fvd=True)`` over two clips: the I3D at 224
    pixels on the CPU, a finite FVD and the I3D's seconds in each record."""
    from ctrlv_tpu_torch.data import get_dataloader
    from ctrlv_tpu_torch.tools.common import build_models

    cfg = _config(PortConfig, tmp_path, train_W=16, device="cpu", mixed_precision="no")
    models = build_models(cfg, tiny=True)
    _, loader = get_dataloader(cfg.data_root, cfg.dataset_name, if_train=False, batch_size=1,
                               clip_length=cfg.clip_length, shuffle=False, train_H=16, train_W=16)
    summary, samples = eval_video_generation.evaluate(
        eval_video_generation.make_pipeline(models), loader, cfg, export=False, compute_fvd=True)
    assert len(samples) == 2 and np.isfinite(summary["fvd"])
    assert all(s["fvd_seconds"] > 0 and s["export_seconds"] >= 0 for s in samples)
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("name", sorted(PORT_TOOLS))
def test_the_tools_run_on_the_card_unless_told(name, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT_TOOLS[name].main(_config(PortConfig, tmp_path))
