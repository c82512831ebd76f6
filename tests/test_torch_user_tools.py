"""The port's last user commands and their helpers against the JAX package's.

- ``utils/fourier.py`` against the JAX module (f32, to 1e-6);
  ``tokenize_captions`` and the W&B frame helpers with stub ``wandb`` and
  tokenizer modules, with and without ``wandb``: the same calls as the JAX
  helpers'; ``render_gt_3d_bbox_plots`` (native rasterizer) against the JAX
  one (XLA rasterizer): under 0.2 % of the pixels apart.
- ``tools.run_tracking_metrics``: IoU, the small-box filter, the matcher, AP
  and a video pair's scores bit-equal to the JAX tool's on seeded cases; its
  ``main`` over GIF pairs with a stub detector, as the JAX tool's.
- ``tools.preprocess_dataset``: the same PNGs as the JAX tool's on a nuScenes
  and a KITTI tree; ``tools.dataset_examples``: the JAX tool's lines.
- ``tools.draw_teaser``: against the JAX tool through recorders (the
  requests, their seeds and keywords, the files); then a tiny run on the CPU
  whose files are the recorded results of the port's ``OverallPipeline``
  (held against JAX in tests/test_torch_overall.py): the GIFs, the overlay
  arithmetic and the ground-truth plots.
- Every tool runs on the card unless told ``--device cpu``.
"""

import contextlib
import io
import os
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

from ctrlv_tpu_torch.pipelines import OverallPipeline
from ctrlv_tpu_torch.tools import dataset_examples, draw_teaser, preprocess_dataset
from ctrlv_tpu_torch.tools import run_tracking_metrics as tracking
from ctrlv_tpu_torch.utils import fourier, misc
from ctrlv_tpu_torch.utils.config import Config as PortConfig
from ctrlv_tpu_torch.utils.video_io import export_to_video, load_video
from test_datasets_fixtures import _make_kitti, _make_vkitti
from test_nuscenes_native import _build_dataroot
from test_torch_data import _make_bdd100k, _make_davis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


def _jax_tool(monkeypatch, name):
    """A JAX tool's module, imported with the JAX settings its ``common``
    module changes put back afterwards."""
    import importlib

    import jax

    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_entry_size_bytes",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    monkeypatch.syspath_prepend(os.path.join(REPO, "tools"))
    try:
        return importlib.import_module(name)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)


def _objects(rng, frames=3, n=30, live=4, size=(90, 160)):
    """One sample's padded objects: ``live`` boxes in front of the camera."""
    h, w = size
    x1, y1 = rng.uniform(0, w * 0.6, (frames, n)), rng.uniform(0, h * 0.6, (frames, n))
    bbox = np.stack([x1, y1, x1 + rng.uniform(5, w * 0.4, (frames, n)),
                     y1 + rng.uniform(5, h * 0.4, (frames, n))], -1)
    return dict(
        bbox=bbox.astype(np.float32),
        truncated=rng.random((frames, n)).astype(np.float32),
        alpha=rng.uniform(-3, 3, (frames, n)).astype(np.float32),
        dimensions=rng.uniform(1, 3, (frames, n, 3)).astype(np.float32),
        locations=np.stack([rng.uniform(-4, 4, (frames, n)), rng.uniform(0, 2, (frames, n)),
                            rng.uniform(8, 30, (frames, n))], -1).astype(np.float32),
        rotation_y=rng.uniform(-3, 3, (frames, n)).astype(np.float32),
        track_id=rng.integers(0, 40, (frames, n)),
        id_type=rng.integers(0, 11, (frames, n)),
        num_objects=np.full((frames,), live, np.int64),
    )


def test_fourier_equals_jax():
    import jax.numpy as jnp

    from ctrlv_tpu.utils import fourier as jax_fourier

    rng = np.random.default_rng(0)
    objs = {k: v[None] for k, v in _objects(rng).items()}  # (1, F, N, ...)
    objs["num_objects"] = np.asarray([4])
    want = np.asarray(jax_fourier.get_fourier_embeds_from_boundingbox(
        {k: jnp.asarray(v) for k, v in objs.items()}, image_size=(160, 90)))
    got = fourier.get_fourier_embeds_from_boundingbox(
        {k: torch.from_numpy(v) for k, v in objs.items()}, image_size=(160, 90))
    assert got.shape == want.shape == (1, 3, 30, 352)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert (got[:, :, 4:] == 0).all()
    x = rng.uniform(-2, 2, (5, 3)).astype(np.float32)
    np.testing.assert_allclose(fourier.FourierEmbedder(16)(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_fourier.FourierEmbedder(16)(jnp.asarray(x))),
                               atol=1e-6)
    ids = rng.integers(0, 16, (7,))
    np.testing.assert_array_equal(fourier.to_binary(torch.from_numpy(ids)).numpy(),
                                  np.asarray(jax_fourier.to_binary(jnp.asarray(ids))))
    np.testing.assert_array_equal(
        fourier.rescale_bbox(objs["bbox"], (160, 90), (512, 320)).numpy(),
        np.asarray(jax_fourier.rescale_bbox(jnp.asarray(objs["bbox"]), (160, 90), (512, 320))))
    # dropout drops whole objects: each token is all zero or the undropped one
    gen = torch.Generator().manual_seed(0)
    dropped = fourier.get_fourier_embeds_from_boundingbox(
        {k: torch.from_numpy(v) for k, v in objs.items()}, image_size=(160, 90),
        dropout_prob=0.5, generator=gen)
    kept = (dropped == got).all(-1)
    assert (kept | (dropped == 0).all(-1)).all() and not kept[:, :, :4].all()


class _Tokens:
    def __init__(self, ids):
        self.input_ids = ids


class _StubTokenizer:
    model_max_length = 6

    def __init__(self):
        self.calls = []

    def __call__(self, prompts, **kw):
        self.calls.append((list(prompts), kw))
        ids = np.asarray([[len(p) + i for i in range(self.model_max_length)] for p in prompts])
        return _Tokens(torch.from_numpy(ids) if kw["return_tensors"] == "pt" else ids)


def test_tokenize_captions_with_a_stub():
    from ctrlv_tpu.utils.misc import tokenize_captions as jax_tokenize

    ours, ref = _StubTokenizer(), _StubTokenizer()
    prompts = ["a driving scene", "night"]
    got, want = misc.tokenize_captions(prompts, ours), jax_tokenize(prompts, ref)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)
    (p_ours, kw_ours), (p_ref, kw_ref) = ours.calls[0], ref.calls[0]
    assert p_ours == p_ref and kw_ours.pop("return_tensors") == "pt"
    assert kw_ref.pop("return_tensors") == "np" and kw_ours == kw_ref


def _stub_wandb(calls):
    mod = types.ModuleType("wandb")

    class StubImage:
        def __init__(self, data, caption=None, boxes=None):
            calls.append((np.asarray(data), caption, boxes))

    mod.Image = StubImage
    return mod


@pytest.mark.parametrize("with_wandb", [False, True])
def test_wandb_helpers_with_a_stub(monkeypatch, with_wandb):
    from ctrlv_tpu.utils import misc as jax_misc

    rng = np.random.default_rng(1)
    video = rng.random((3, 80, 100, 3)).astype(np.float32)
    objs = {k: v[None] for k, v in _objects(rng, size=(80, 100)).items()}
    calls = {"port": [], "jax": []}
    for side, helpers, objects in (
            ("port", misc, {k: torch.from_numpy(v) for k, v in objs.items()}),
            ("jax", jax_misc, objs)):
        monkeypatch.setitem(sys.modules, "wandb", _stub_wandb(calls[side]) if with_wandb else None)
        assert helpers.wandb_available() == with_wandb
        frames = helpers.wandb_frames_with_bbox(
            torch.from_numpy(video) if side == "port" else video, objects, image_size=(100, 80))
        plain = helpers.tensor2wandbimage(video[0], caption="plain")
        assert len(frames) == (3 if with_wandb else 0) and (plain is None) != with_wandb
    assert len(calls["port"]) == len(calls["jax"]) == (4 if with_wandb else 0)
    for (data, caption, boxes), (data_r, caption_r, boxes_r) in zip(calls["port"], calls["jax"]):
        np.testing.assert_array_equal(data, data_r)
        assert caption == caption_r and boxes == boxes_r


def _mismatched(out, ref):
    return (np.abs(out - ref).max(axis=-1) > 1e-4).mean()


@pytest.mark.parametrize("case", ["3d", "3d+2d", "2d_no_calib"])
def test_gt_plots_against_jax(case):
    """Native against XLA: at most 0.2 % of the pixels apart, as the
    trajectory frame is held (tests/test_torch_data.py)."""
    from ctrlv_tpu.utils.misc import render_gt_3d_bbox_plots as jax_plots

    rng = np.random.default_rng(3)
    objs = _objects(rng)
    calib = None if case == "2d_no_calib" else np.asarray(
        [[120.0, 0.0, 80.0, 0.0], [0.0, 120.0, 45.0, 0.0], [0.0, 0.0, 1.0, 0.0]], np.float32)
    plot_2d = case != "3d"
    got = misc.render_gt_3d_bbox_plots({k: torch.from_numpy(v) for k, v in objs.items()},
                                       None if calib is None else torch.from_numpy(calib),
                                       90, 160, plot_2d_bbox=plot_2d)
    want = jax_plots(objs, calib, 90, 160, plot_2d_bbox=plot_2d)
    assert len(got) == len(want) == 3
    for out, ref in zip(got, want):
        assert out.shape == ref.shape == (90, 160, 3) and out.dtype == np.float32
        assert _mismatched(out, ref) < 0.002
        assert (out < 1).any() and out.min() >= 0 and out.max() <= 1
    assert not np.array_equal(got[0], got[-1])  # plum first, gold later
    if not plot_2d:  # the 3D wireframes alone: colours only from the two palettes
        assert (got[0] == 1).mean() > 0.5


def test_tracking_metrics_equal_jax(monkeypatch):
    ref = _jax_tool(monkeypatch, "run_tracking_metrics")
    rng = np.random.default_rng(4)

    def boxes(n, conf=False):
        xy = rng.uniform(0, 80, (n, 2))
        b = np.concatenate([xy, xy + rng.uniform(2, 40, (n, 2))], 1)
        return np.concatenate([b, rng.random((n, 1))], 1) if conf else b

    a, b = boxes(6), boxes(9)
    np.testing.assert_array_equal(tracking.box_iou(a, b), ref.box_iou(a, b))
    np.testing.assert_array_equal(tracking.filter_small_boxes(b, (100, 120)),
                                  ref.filter_small_boxes(b, (100, 120)))
    np.testing.assert_array_equal(tracking.IOU_THRESHOLDS, ref.IOU_THRESHOLDS)
    np.testing.assert_array_equal(tracking.CONF_SWEEP, ref.CONF_SWEEP)
    gen, gt = [], []
    for f in range(5):
        g = boxes(5)
        jitter = np.concatenate([g + rng.normal(0, 2, g.shape), rng.random((5, 1))], 1)
        gen.append(np.concatenate([jitter, boxes(2, conf=True)]) if f != 3 else np.zeros((0, 5)))
        gt.append(g if f != 1 else np.zeros((0, 4)))
        np.testing.assert_array_equal(tracking.match_frame(gen[-1], gt[-1]),
                                      ref.match_frame(gen[-1], gt[-1]))
    correct = rng.random((20, 10)) < 0.6
    conf = rng.random(20)
    np.testing.assert_array_equal(tracking.average_precision(correct, conf, 15),
                                  ref.average_precision(correct, conf, 15))
    got, want = tracking.evaluate_video_pair(gen, gt, (100, 120)), ref.evaluate_video_pair(
        gen, gt, (100, 120))
    assert got == want and 0 < got["mAP50-95"] < 1


def test_tracking_main_with_a_stub_detector(monkeypatch, tmp_path):
    from ctrlv_tpu.utils.config import Config as JaxConfig

    ref = _jax_tool(monkeypatch, "run_tracking_metrics")
    rng = np.random.default_rng(5)
    for i in range(2):
        for kind in ("generated_video", "gt_video"):
            frames = [(rng.random((24, 32, 3)) * 255).astype(np.uint8) for _ in range(3)]
            export_to_video(frames, str(tmp_path / f"{kind}_{i}.gif"))

    def detect(frame):  # boxes from the frame's brightest pixels, the mean as confidence
        ys, xs = np.nonzero(frame.mean(-1) > 200)
        return np.asarray([[xs.min(), ys.min(), xs.max(), ys.max(), frame.mean() / 255.0],
                           [0.0, 0.0, 20.0, 10.0, 0.5]])

    devices = []
    monkeypatch.setattr(tracking, "get_detector", lambda device=None: devices.append(device)
                        or detect)
    monkeypatch.setattr(ref, "get_detector", lambda: detect)
    monkeypatch.setattr(sys, "argv", ["run_tracking_metrics", "--eval_dir", str(tmp_path)])
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out):
        got = tracking.main(PortConfig(eval_dir=str(tmp_path), device="cpu"))
    with contextlib.redirect_stdout(err):
        ref.main()
    assert devices == ["cpu"] and len(got) == 2
    assert out.getvalue() == err.getvalue()
    # without a detector the tool says so and stops, as the JAX tool does
    monkeypatch.setattr(tracking, "get_detector", lambda device=None: None)
    assert tracking.main(PortConfig(eval_dir=str(tmp_path), device="cpu")) is None


def _pngs(directory):
    return {os.path.relpath(os.path.join(d, f), directory): np.asarray(Image.open(os.path.join(d, f)))
            for d, _, files in os.walk(directory) for f in sorted(files) if f.endswith(".png")}


@pytest.mark.parametrize("name", ["nuscenes", "kitti"])
def test_preprocess_dataset_equals_jax(monkeypatch, tmp_path, name):
    from ctrlv_tpu.utils.config import Config as JaxConfig

    ref = _jax_tool(monkeypatch, "preprocess_dataset")
    if name == "nuscenes":
        root = _build_dataroot(tmp_path)
    else:
        root = str(tmp_path / "data")
        _make_kitti(tmp_path / "data", n=4)
    written = {}
    for side, cls, tool in (("jax", JaxConfig, ref), ("port", PortConfig, preprocess_dataset)):
        kw = dict(device="cpu") if side == "port" else {}
        with contextlib.redirect_stdout(io.StringIO()):
            tool.main(cls(dataset_name=name, data_root=root, train_H=32, train_W=64,
                          output_dir=str(tmp_path / side), **kw))
        # nuScenes: by token under the output directory; KITTI: into its bbox_02
        written[side] = _pngs(str(tmp_path / side) if name == "nuscenes" else
                              os.path.join(root, "kitti", "training", "bbox_02"))
    assert sorted(written["port"]) == sorted(written["jax"])
    assert len(written["jax"]) == (7 if name == "nuscenes" else 4)
    for key, img in written["jax"].items():
        np.testing.assert_array_equal(written["port"][key], img, err_msg=key)
        assert img.shape == (32, 64, 3) and (img > 0).any()


def _all_trees(root):
    _make_kitti(root, n=6)
    _make_vkitti(root, n=7)
    _make_bdd100k(root)
    _make_davis(root)


@pytest.mark.parametrize("present", [True, False])
def test_dataset_examples_lines_equal_jax(monkeypatch, tmp_path, present):
    from ctrlv_tpu.utils.config import Config as JaxConfig

    ref = _jax_tool(monkeypatch, "dataset_examples")
    if present:
        _all_trees(tmp_path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ref.main(JaxConfig(data_root=str(tmp_path)))
    want = out.getvalue().splitlines()
    with contextlib.redirect_stdout(io.StringIO()):
        got = dataset_examples.main(PortConfig(data_root=str(tmp_path), device="cpu"))
    assert len(got) == len(want) == 6
    if present:
        assert got == want
        assert all("unavailable" not in line for line in got)
    else:  # the loader's message names each package's own module
        assert [line.replace("ctrlv_tpu_torch/", "ctrlv_tpu/") for line in got] == want
        assert got[0] == want[0] and "unavailable (FileNotFoundError" in got[1]


def _teaser_config(cls, tmp_path, **kw):
    return cls(dataset_name="synthetic", data_root=str(tmp_path), clip_length=3, train_H=16,
               train_W=16, num_inference_steps=2, decode_chunk_size=2, fps=5, seed=3,
               output_dir=str(tmp_path / "out"), **kw)


def _fake_result(num_frames, h, w, value):
    video = np.full((num_frames, h, w, 3), value, np.float32)
    return dict(video=video, bbox_video=video[::-1] * 0.5, best_guidance=(1.0, 2.0), miou=0.25)


def test_teaser_requests_and_files_equal_jax(monkeypatch, tmp_path):
    """The JAX tool and the port's with recorders for the pipeline and the
    plots: the same requests, seeds, keywords, files and plot inputs."""
    from ctrlv_tpu.utils.config import Config as JaxConfig

    ref = _jax_tool(monkeypatch, "draw_teaser")
    calls = {"jax": [], "port": []}
    plots = {"jax": [], "port": []}

    class JaxRecorder:
        def __init__(self, *args):
            pass

        def __call__(self, image, bbox, rng, **kw):
            seed = int(np.asarray(rng)[-1])  # a raw PRNGKey(s) is [0, s]
            calls["jax"].append((np.asarray(image), np.asarray(bbox), seed, kw))
            return _fake_result(kw["num_frames"], *np.shape(image)[:2], 0.1 * len(calls["jax"]))

    def port_call(self, image, bbox, generator=None, **kw):
        calls["port"].append((image.numpy(), bbox.numpy(), generator.initial_seed(), kw))
        return _fake_result(kw["num_frames"], *image.shape[:2], 0.1 * len(calls["port"]))

    def recording_plots(side):
        def render(objects, calib, h, w, plot_2d_bbox=False):
            plots[side].append(({k: np.asarray(v) for k, v in objects.items()}, calib, h, w,
                                plot_2d_bbox))
            return [np.ones((h, w, 3), np.float32)] * 2
        return render

    monkeypatch.setattr(ref, "build_models", lambda cfg, **kw: dict.fromkeys(
        ("unet", "unet_params", "vae", "vae_params", "clip", "clip_params", "ctrl",
         "ctrl_params")))
    for name in ("VideoDiffusionPipeline", "StableVideoControlPipeline"):
        monkeypatch.setattr(ref, name, lambda *a, **k: None)
    monkeypatch.setattr(ref, "OverallPipeline", JaxRecorder)
    monkeypatch.setattr(ref, "render_gt_3d_bbox_plots", recording_plots("jax"))
    monkeypatch.setattr(OverallPipeline, "__call__", port_call)
    monkeypatch.setattr(draw_teaser, "render_gt_3d_bbox_plots", recording_plots("port"))

    with contextlib.redirect_stdout(io.StringIO()) as out_jax:
        ref.main(_teaser_config(JaxConfig, tmp_path / "jax"), max_samples=2)
    with contextlib.redirect_stdout(io.StringIO()) as out_port:
        records = draw_teaser.main(_teaser_config(PortConfig, tmp_path / "port", device="cpu"),
                                   max_samples=2)
    assert out_port.getvalue() == out_jax.getvalue()
    assert len(calls["port"]) == len(calls["jax"]) == 2 * draw_teaser.NUM_SEEDS == 6
    for (img, bbox, seed, kw), (img_r, bbox_r, seed_r, kw_r) in zip(calls["port"], calls["jax"]):
        np.testing.assert_array_equal(img, img_r)
        np.testing.assert_array_equal(bbox, bbox_r)
        assert kw == kw_r and seed == seed_r
    assert [c[2] for c in calls["port"]] == [3, 4, 5, 3, 4, 5]
    assert len(plots["port"]) == len(plots["jax"]) == 2
    for (objs, calib, h, w, flag), (objs_r, calib_r, h_r, w_r, flag_r) in zip(plots["port"],
                                                                               plots["jax"]):
        assert (h, w, flag) == (h_r, w_r, flag_r) == (16, 16, False)
        assert calib_r is not None and calib.shape == (3, 4)  # the synthetic clips' camera
        np.testing.assert_array_equal(np.asarray(calib), calib_r)
        assert sorted(objs) == sorted(objs_r)
        for k in objs_r:
            np.testing.assert_array_equal(objs[k], objs_r[k], err_msg=k)
    files = sorted(os.listdir(tmp_path / "port" / "out" / "teaser"))
    # a sample: two GIFs and three overlays (every frame of 3) a seed, two plots
    assert files == sorted(os.listdir(tmp_path / "jax" / "out" / "teaser"))
    assert len(files) == 2 * (3 * 5 + 2)
    for name in files:
        a = load_video(str(tmp_path / "port/out/teaser" / name)) if name.endswith(".gif") else \
            np.asarray(Image.open(tmp_path / "port/out/teaser" / name))
        b = load_video(str(tmp_path / "jax/out/teaser" / name)) if name.endswith(".gif") else \
            np.asarray(Image.open(tmp_path / "jax/out/teaser" / name))
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert len(records) == 2 and [r["seed"] for r in records[1]["requests"]] == [3, 4, 5]
    assert records[0]["plots"] == 2 and records[0]["loader_wait_seconds"] >= 0


def test_teaser_tiny_run_on_the_cpu(monkeypatch, tmp_path):
    """One clip through the tiny models, two seeds and 3 stage-1 steps (the
    requests' keywords are held against the JAX tool's above): each file is
    what the port's pipeline returned for its seed."""
    results = []
    real_call = OverallPipeline.__call__

    def recorder(self, image, bbox, generator=None, **kw):
        seed = generator.initial_seed()
        res = real_call(self, image, bbox, generator, **kw)
        results.append((seed, res, bbox.numpy()))
        return res

    monkeypatch.setattr(OverallPipeline, "__call__", recorder)
    monkeypatch.setattr(draw_teaser, "NUM_SEEDS", 2)
    monkeypatch.setattr(draw_teaser, "STAGE1_STEPS", 3)
    cfg = _teaser_config(PortConfig, tmp_path, device="cpu", mixed_precision="no")
    records = draw_teaser.main(cfg)
    out = tmp_path / "out" / "teaser"
    assert [seed for seed, _, _ in results] == [3, 4]
    assert not np.array_equal(results[0][1]["video"], results[1][1]["video"])
    for s, (seed, res, _) in enumerate(results):
        assert load_video(str(out / f"sample0_seed{s}.gif")).shape == (3, 16, 16, 3)
        bbox_gif = load_video(str(out / f"sample0_seed{s}_bbox.gif"))
        assert bbox_gif.shape[1:] == (16, 16, 3)
        overlay = np.maximum(res["video"], res["bbox_video"] * 0.8)
        for f in range(3):  # every F // 5 = 0 -> 1 frames
            np.testing.assert_array_equal(
                np.asarray(Image.open(out / f"sample0_seed{s}_frame{f}.png")),
                (overlay[f] * 255).astype(np.uint8))
    for f in range(3):
        plot = np.asarray(Image.open(out / f"sample0_gt_3d_bbox_frame{f}.png"))
        assert plot.shape == (16, 16, 3)
    assert len(records) == 1 and len(records[0]["requests"]) == 2
    assert all(np.isfinite(r["miou"]) and r["seconds"] > 0 for r in records[0]["requests"])


@pytest.mark.parametrize("tool", ["draw_teaser", "run_tracking_metrics", "preprocess_dataset",
                                  "dataset_examples"])
def test_the_tools_run_on_the_card_unless_told(monkeypatch, tmp_path, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = {"draw_teaser": draw_teaser, "run_tracking_metrics": tracking,
              "preprocess_dataset": preprocess_dataset, "dataset_examples": dataset_examples}[tool]
    cfg = _teaser_config(PortConfig, tmp_path, eval_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(cfg)
