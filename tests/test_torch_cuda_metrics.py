"""The metrics' networks on the card against the same modules on the CPU.

These tests need an NVIDIA GPU and skip without one. On the card, from the
repository root (``--noconftest``: tests/conftest.py configures JAX, which a
GPU host of the port need not have; this file imports only torch and the
port):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_metrics.py

- The I3D's features and LPIPS's distances, seeded weights, on the card in
  IEEE f32 (``metrics.common.ieee_f32``, TF32 off inside, back on after)
  against the CPU's: 1e-4 relative L2, the same f32 arithmetic in cuDNN's
  order of sums.
- ``evaluate_media_dir`` on the card against the CPU on GIFs the test
  writes: SSIM, PSNR and LPIPS to 1e-4 relative, FVD to 1e-3.
"""

import numpy as np
import pytest
import torch

from ctrlv_tpu_torch.metrics import lpips_distance, lpips_init_params
from ctrlv_tpu_torch.metrics.common import ieee_f32
from ctrlv_tpu_torch.metrics.fvd import FVD
from ctrlv_tpu_torch.metrics.lpips import build_lpips
from ctrlv_tpu_torch.metrics.offline_eval import evaluate_media_dir
from ctrlv_tpu_torch.utils.video_io import export_to_video

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_i3d_features_on_the_card_match_the_cpu(cuda):
    videos = np.random.default_rng(0).uniform(0, 1, (2, 11, 256, 410, 3)).astype(np.float32)
    sd = FVD(device="cpu", seed=4).model.state_dict()
    want = FVD(state_dict=sd, device="cpu").features(videos)
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    got = FVD(state_dict=sd, device=cuda).features(videos)
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == before
    assert got.shape == (2, 400) and _rel_l2(got, want) < 1e-4


def test_lpips_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(1)
    a = rng.uniform(-1, 1, (6, 256, 410, 3)).astype(np.float32)
    b = np.clip(a + 0.3 * rng.standard_normal(a.shape), -1, 1).astype(np.float32)
    sd = lpips_init_params(2)
    want = lpips_distance(build_lpips(sd, "cpu"), a, b).numpy()
    got = lpips_distance(build_lpips(sd, cuda), a, b).cpu().numpy()
    assert _rel_l2(got, want) < 1e-4
    with ieee_f32():
        assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32


def test_evaluate_media_dir_on_the_card_matches_the_cpu(cuda, tmp_path):
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:64, 0:96]
    for i in range(3):
        for kind, jitter in (("gt_videos", 0.0), ("generated_videos", 0.2)):
            clip = [np.clip(0.5 + 0.4 * np.sin(xx / 6 + t + i)[..., None] * np.cos(yy / 5 - t)[..., None]
                            + jitter * rng.standard_normal((64, 96, 3)), 0, 1) for t in range(24)]
            export_to_video([(f * 255).astype(np.uint8) for f in clip],
                            str(tmp_path / f"{kind}_{i}.gif"))
    kw = dict(fvd_state_dict=FVD(device="cpu", seed=5).model.state_dict(),
              lpips_state_dict=lpips_init_params(6))
    want = evaluate_media_dir(str(tmp_path), device="cpu", **kw)
    got = evaluate_media_dir(str(tmp_path), device=cuda, **kw)
    assert got["num_pairs"] == want["num_pairs"] == 3
    for k in ("ssim", "psnr", "lpips"):
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    assert got["fvd"] == pytest.approx(want["fvd"], rel=1e-3)
