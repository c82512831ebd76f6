"""The port's metrics against the JAX package's, on the CPU.

- Bit-equal (numpy on both sides): DAVIS J&F, ``pil_luma_uint8``,
  ``stage1_frame_f_measure`` and ``frechet_distance`` on seeded inputs; the
  I3D and LPIPS converters, each the inverse of the JAX package's, both ways.
- Resizes against ``jax.image.resize(..., "bilinear")`` to 1e-5 (absolute
  and relative): both are f32 with the same triangle kernel, summed in
  another order over up to 16 taps a pixel.
- I3D features against the JAX forward to 1e-4 relative L2, with JAX
  variables carried across and with ``i3d_synthetic_sd`` loaded into both,
  at the golden input and at an odd shape, and against ``golden_i3d.npz``:
  f32 convolutions of another order of sums through 57 layers.
- LPIPS against the JAX forward and ``golden_lpips.npz`` to 1e-5 (the
  distances are O(1)).
- ``evaluate_media_dir`` on GIFs the test writes, with the same weights on
  both sides: SSIM, PSNR and LPIPS to 1e-4 relative; FVD to 1e-3 relative:
  with two pairs it is a difference of traces of singular covariances, which
  the features' 1e-5-level differences move by more than they move a score.
"""

import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlv_tpu_torch.convert import i3d_flax_to_state_dict, lpips_flax_to_state_dict
from ctrlv_tpu_torch.metrics import (
    LPIPS,
    DAVISEvaluation,
    db_eval_boundary,
    db_eval_iou,
    f_measure,
    lpips_distance,
    lpips_init_params,
    pil_luma_uint8,
    stage1_frame_f_measure,
)
from ctrlv_tpu_torch.metrics import offline_eval
from ctrlv_tpu_torch.metrics.fvd import FVD, InceptionI3d, frechet_distance, preprocess_fvd
from ctrlv_tpu_torch.metrics.lpips import build_lpips
from ctrlv_tpu_torch.utils.resize import resize_bilinear

FIX = Path(__file__).parent / "fixtures"
sys.path.insert(0, str(FIX))

from make_goldens import (  # noqa: E402
    i3d_golden_input,
    i3d_synthetic_sd,
    lpips_golden_inputs,
    lpips_synthetic_sd,
)
from svd_manifests import i3d_manifest  # noqa: E402

torch.set_num_threads(2)


def _masks(rng, n, f, h, w):
    """n objects' (F, H, W) masks: moving rectangles with speckle."""
    out = np.zeros((n, f, h, w), bool)
    for i in range(n):
        y, x = rng.integers(0, h // 2), rng.integers(0, w // 2)
        for t in range(f):
            out[i, t, y + t:y + t + h // 3, x:x + w // 3 + t] = True
        out[i] ^= rng.random((f, h, w)) < 0.02
    return out


def test_fandj_and_davis_are_bit_equal():
    from ctrlv_tpu.metrics import DAVISEvaluation as JaxDAVIS
    from ctrlv_tpu.metrics import db_eval_boundary as jax_boundary
    from ctrlv_tpu.metrics import db_eval_iou as jax_iou
    from ctrlv_tpu.metrics import f_measure as jax_f

    rng = np.random.default_rng(4)
    gt, res = _masks(rng, 3, 4, 40, 56), _masks(rng, 2, 4, 40, 56)
    void = rng.random((4, 40, 56)) < 0.05
    np.testing.assert_array_equal(db_eval_iou(gt[0], res[0], void), jax_iou(gt[0], res[0], void))
    assert db_eval_iou(gt[0, 0], res[0, 0]) == jax_iou(gt[0, 0], res[0, 0])
    np.testing.assert_array_equal(db_eval_boundary(gt[1], res[1], void),
                                  jax_boundary(gt[1], res[1], void))
    for th in (0.008, 0.02, 3):
        assert f_measure(res[0, 1], gt[0, 1], bound_th=th) == jax_f(res[0, 1], gt[0, 1], bound_th=th)
    assert f_measure(np.zeros((8, 8)), gt[0, 0, :8, :8]) == jax_f(np.zeros((8, 8)), gt[0, 0, :8, :8])
    j, f = DAVISEvaluation.evaluate_semisupervised(gt, res.astype(np.float64))
    j_ref, f_ref = JaxDAVIS.evaluate_semisupervised(gt, res.astype(np.float64))
    np.testing.assert_array_equal(j, j_ref)
    np.testing.assert_array_equal(f, f_ref)
    assert j[2].tolist() == [0.0] * 4  # the padded object
    with pytest.raises(ValueError, match="more object"):
        DAVISEvaluation.evaluate_semisupervised(res, gt)


def test_stage1_frame_scores_are_bit_equal():
    from ctrlv_tpu.metrics import pil_luma_uint8 as jax_luma
    from ctrlv_tpu.metrics import stage1_frame_f_measure as jax_stage1

    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, size=(3, 37, 53, 3), dtype=np.uint8)
    np.testing.assert_array_equal(pil_luma_uint8(rgb), jax_luma(rgb))
    for _ in range(3):
        gen = np.zeros((48, 80, 3), np.float32)
        y, x = rng.integers(0, 20, 2)
        gen[y:y + 20, x:x + 40] = rng.random((20, 40, 3)) * 0.9 + 0.1
        gen += (rng.random(gen.shape) < 0.1) * rng.random(gen.shape) * (6.0 / 255.0)
        gt = np.zeros((48, 80, 3), np.uint8)
        gt[y + 2:y + 24, x + 3:x + 38] = rng.integers(30, 255, (22, 35, 3), dtype=np.uint8)
        got = stage1_frame_f_measure(np.clip(gen, 0, 1), gt)
        assert got == jax_stage1(np.clip(gen, 0, 1), gt) and 0.0 < got < 1.0
    with pytest.raises(ValueError, match="uint8"):
        pil_luma_uint8(rgb.astype(np.float32))


@pytest.mark.parametrize("n_a,n_b,dim", [(2, 2, 400), (5, 7, 16), (60, 70, 16)])
def test_frechet_distance_is_bit_equal(n_a, n_b, dim):
    """The singular case (N < D) takes the eps-jitter retry on both sides."""
    from ctrlv_tpu.metrics.fvd import frechet_distance as jax_frechet

    rng = np.random.default_rng(n_a)
    a = rng.standard_normal((n_a, dim)).astype(np.float32)
    b = (rng.standard_normal((n_b, dim)) * 1.3 + 0.2).astype(np.float32)
    got = frechet_distance(a, b)
    assert np.isfinite(got) and got == jax_frechet(a, b)


def _i3d_template():
    from ctrlv_tpu.metrics.fvd import InceptionI3d as JaxI3d

    shapes = jax.eval_shape(lambda k: JaxI3d().init(k, i3d_golden_input()), jax.random.PRNGKey(0))
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)


def _random_flax_i3d(seed=3):
    """JAX I3D variables drawn in the JAX tree itself: kernels lecun-normal,
    norm scales near 1, variances positive."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, _i3d_template())


@pytest.fixture(scope="module")
def i3d_weights():
    """{name: (JAX variables, the port's state dict)} for both weight sets."""
    from ctrlv_tpu.metrics.fvd import i3d_torch_to_flax

    variables = _random_flax_i3d()
    synth = i3d_synthetic_sd()
    return {
        "jax_variables": (variables, i3d_flax_to_state_dict(variables)),
        "synthetic_sd": (i3d_torch_to_flax(synth, expected=_i3d_template()),
                         {k: torch.from_numpy(v) for k, v in synth.items()}),
    }


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_converters_round_trip_bit_for_bit(i3d_weights):
    from ctrlv_tpu.metrics.fvd import i3d_torch_to_flax
    from ctrlv_tpu.metrics.lpips import lpips_torch_to_flax

    variables, _ = i3d_weights["jax_variables"]
    there = i3d_flax_to_state_dict(variables)
    back = jax.tree_util.tree_leaves_with_path(i3d_torch_to_flax(there, expected=variables))
    ref = jax.tree_util.tree_leaves_with_path(variables)
    assert [p for p, _ in back] == [p for p, _ in ref]
    assert all(np.array_equal(a, b) and a.dtype == b.dtype for (_, a), (_, b) in zip(back, ref))
    synth = i3d_synthetic_sd()
    again = i3d_flax_to_state_dict(i3d_torch_to_flax(synth))
    assert sorted(again) == sorted(synth) == sorted(i3d_manifest())
    assert all(np.array_equal(again[k].numpy(), v) for k, v in synth.items())

    lsd = lpips_synthetic_sd()
    l_again = lpips_flax_to_state_dict(lpips_torch_to_flax(lsd))
    assert sorted(l_again) == sorted(lsd)
    assert all(np.array_equal(l_again[k].numpy(), v) for k, v in lsd.items())
    params = lpips_torch_to_flax(lsd)
    l_back = lpips_torch_to_flax({k: v.numpy() for k, v in lpips_flax_to_state_dict(params).items()})
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(l_back), jax.tree.leaves(params)))


def test_published_names_load_strictly():
    """A pytorch-i3d state dict (the manifest's names, no num_batches_tracked)
    and an lpips state dict load with strict=True."""
    i3d = InceptionI3d()
    i3d.load_state_dict({k: torch.zeros(s) for k, s in i3d_manifest().items()}, strict=True)
    assert {k for k in i3d.state_dict() if not k.endswith("num_batches_tracked")} == set(i3d_manifest())
    LPIPS().load_state_dict({k: torch.from_numpy(v) for k, v in lpips_synthetic_sd().items()},
                            strict=True)
    assert sorted(lpips_init_params(0)) == sorted(lpips_synthetic_sd())


@pytest.mark.parametrize("src,dst", [((37, 53), (24, 30)), ((64, 96), (224, 336)),
                                     ((320, 512), (224, 358)), ((256, 410), (224, 359))])
def test_resize_matches_jax(src, dst):
    rng = np.random.default_rng(src[0])
    x = rng.uniform(0, 1, (2, *src, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 3), "bilinear"))
    got = resize_bilinear(torch.from_numpy(x), dst).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(1, 16, 64, 64, 3), (1, 11, 50, 66, 3)])
@pytest.mark.parametrize("weights", ["jax_variables", "synthetic_sd"])
def test_i3d_features_match_jax(i3d_weights, weights, shape):
    from ctrlv_tpu.metrics.fvd import InceptionI3d as JaxI3d

    variables, sd = i3d_weights[weights]
    x = i3d_golden_input() if shape == (1, 16, 64, 64, 3) else np.random.default_rng(11).uniform(
        -1, 1, shape).astype(np.float32)
    want = np.asarray(jax.jit(JaxI3d().apply)(variables, x))
    model = InceptionI3d()
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous()).numpy()
    assert got.shape == want.shape == (1, 400)
    assert _rel_l2(got, want) < 1e-4
    if weights == "synthetic_sd" and shape == (1, 16, 64, 64, 3):
        assert _rel_l2(got, np.load(FIX / "golden_i3d.npz")["expected"]) < 1e-4


def test_fvd_features_match_jax(i3d_weights):
    """Through the preprocessing (resize of the shorter side, crop, [-1, 1])."""
    from ctrlv_tpu.metrics.fvd import FVD as JaxFVD
    from ctrlv_tpu.metrics.fvd import preprocess_fvd as jax_preprocess

    variables, sd = i3d_weights["synthetic_sd"]
    videos = np.random.default_rng(12).uniform(0, 1, (2, 5, 72, 96, 3)).astype(np.float32)
    np.testing.assert_allclose(
        preprocess_fvd(torch.from_numpy(videos), 64).numpy(),
        np.asarray(jax_preprocess(jnp.asarray(videos), 64)), atol=2e-5, rtol=0)
    got = FVD(state_dict=sd, device="cpu", target_size=64, batch_size=1).features(videos)
    want = JaxFVD(params=variables, target_size=64)._features(videos)
    assert _rel_l2(got, want) < 1e-4


def test_lpips_matches_jax_and_golden():
    from ctrlv_tpu.metrics.lpips import LPIPS as JaxLPIPS
    from ctrlv_tpu.metrics.lpips import lpips_distance as jax_lpips
    from ctrlv_tpu.metrics.lpips import lpips_torch_to_flax

    x0, x1 = lpips_golden_inputs()  # NCHW
    a, b = x0.transpose(0, 2, 3, 1), x1.transpose(0, 2, 3, 1)
    sd = lpips_synthetic_sd()
    model = build_lpips({k: torch.from_numpy(v) for k, v in sd.items()}, "cpu")
    got = lpips_distance(model, a, b).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_lpips(lpips_torch_to_flax(sd), a, b)),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, np.load(FIX / "golden_lpips.npz")["expected"],
                               atol=1e-5, rtol=1e-5)
    # JAX params of the JAX tree's own shapes, carried across
    rng = np.random.default_rng(6)
    shapes = jax.eval_shape(lambda k: JaxLPIPS().init(k, a, b), jax.random.PRNGKey(0))
    params = jax.tree.map(lambda s: rng.uniform(0, 0.1, s.shape).astype(np.float32), shapes)
    params["params"]["shift"] = np.asarray([-0.03, -0.088, -0.188], np.float32)
    params["params"]["scale"] = np.asarray([0.458, 0.448, 0.45], np.float32)
    model = build_lpips(lpips_flax_to_state_dict(params), "cpu")
    np.testing.assert_allclose(lpips_distance(model, a, b).numpy(),
                               np.asarray(jax_lpips(params, a, b)), atol=1e-5, rtol=1e-5)
    assert float(lpips_distance(model, a, a).abs().max()) == 0.0


def _write_media_dir(root, pairs=2, frames=12, h=40, w=64):
    """GIF pairs whose frames differ from one to the next (a GIF merges equal
    neighbours)."""
    from ctrlv_tpu_torch.utils.video_io import export_to_video

    rng = np.random.default_rng(8)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(pairs):
        for kind, jitter in (("gt_videos", 0.0), ("generated_videos", 0.15)):
            clip = []
            for t in range(frames):
                base = np.stack([np.sin(xx / (5 + c) + t * 0.7 + i) * np.cos(yy / (4 + c) - t * 0.3)
                                 for c in range(3)], -1)
                frame = 0.5 + 0.4 * base + jitter * rng.standard_normal(base.shape)
                clip.append((np.clip(frame, 0, 1) * 255).astype(np.uint8))
            export_to_video(clip, str(root / f"{kind}_{i}.gif"))
    (root / "gt_labels_0.pkl").write_bytes(b"")  # not a video: ignored


def test_evaluate_media_dir_matches_jax(i3d_weights, tmp_path, monkeypatch):
    from ctrlv_tpu.metrics.lpips import lpips_torch_to_flax
    from ctrlv_tpu.metrics.offline_eval import evaluate_media_dir as jax_evaluate
    from ctrlv_tpu.metrics.offline_eval import pair_video_files as jax_pairs

    _write_media_dir(tmp_path)
    assert offline_eval.pair_video_files(str(tmp_path)) == jax_pairs(str(tmp_path))
    # i3d_synthetic_sd's features do not depend on the input at 224 pixels (its
    # activations die out): FVD would be 0 on both sides
    variables, i3d_sd = i3d_weights["jax_variables"]
    lpips_sd = lpips_synthetic_sd()
    kw = dict(num_frames=5, size=(96, 64))
    want = jax_evaluate(str(tmp_path), fvd_params=variables,
                        lpips_params=lpips_torch_to_flax(lpips_sd), **kw)
    got = offline_eval.evaluate_media_dir(
        str(tmp_path), fvd_state_dict=i3d_sd,
        lpips_state_dict={k: torch.from_numpy(v) for k, v in lpips_sd.items()}, device="cpu", **kw)
    assert sorted(got) == sorted(want) == ["fvd", "lpips", "num_pairs", "psnr", "ssim"]
    assert got["num_pairs"] == want["num_pairs"] == 2
    for k in ("ssim", "psnr", "lpips"):
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    assert got["fvd"] == pytest.approx(want["fvd"], rel=1e-3) and got["fvd"] > 0

    # LPIPS weights from the file CTRLV_LPIPS_WEIGHTS names; none without it
    path = tmp_path / "lpips.pt"
    torch.save({k: torch.from_numpy(v) for k, v in lpips_sd.items()}, path)
    monkeypatch.setenv("CTRLV_LPIPS_WEIGHTS", str(path))
    again = offline_eval.evaluate_media_dir(str(tmp_path), fvd_state_dict=i3d_sd, device="cpu",
                                            **kw)
    assert again == got
    monkeypatch.delenv("CTRLV_LPIPS_WEIGHTS")
    assert "lpips" not in offline_eval.evaluate_media_dir(str(tmp_path), device="cpu", **kw)


def test_offline_eval_command(tmp_path, capsys):
    import json

    _write_media_dir(tmp_path, frames=6)
    offline_eval.main([str(tmp_path), "--device", "cpu", "--num_frames", "3", "--width", "32",
                       "--height", "32"])
    lines = capsys.readouterr().out.splitlines()
    payload = json.loads(lines[1])
    assert payload["num_pairs"] == 2 and np.isfinite(payload["fvd"])
    with pytest.raises(FileNotFoundError):
        offline_eval.evaluate_media_dir(str(tmp_path / "none"), device="cpu")


def test_metrics_run_on_the_card_unless_told(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FVD()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_lpips(lpips_init_params(0))
    _write_media_dir(tmp_path, pairs=1, frames=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        offline_eval.main([str(tmp_path)])
