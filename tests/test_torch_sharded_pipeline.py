"""The port's samplers on a mesh of two ``gloo`` ranks.

- The tiny Box2Video sampler on a (1, 2) mesh at an odd F = 3 (frames 2 + 1
  over the frame axis; the shapes of ``tests/test_torch_sampler.py``, whose
  compiled JAX sampler the persistent cache keeps): every rank returns the
  clip of the JAX package's
  unsharded ``StableVideoControlPipeline`` on the same seeded weights, with
  the JAX draws handed in (as ``tests/test_torch_sampler.py`` does), and the
  port's one-rank clip.
- The tiny overall pipeline on a (2, 1) mesh (the five stage-1 candidates 3
  + 2 over the data axis): the one-rank result, the same candidate chosen.

The ranks are spawned processes (``tests/torch_dist_cases.py``); the JAX
reference and the one-rank run are computed in the test's own process while
they run.

Tolerance: against JAX, the sampler test's 1e-3 absolute on frames in [0, 1]
(f32, CLIP, two VAE encodes, two ControlNet+UNet steps and the decode, each
with its own order of sums). Against the port's one rank the same 1e-3, and
5e-4 relative L2 (7.9e-5 measured): a frame shard computes each frame's
spatial layers on fewer frames, so the batched matmuls and convolutions may
sum in another order (1e-6 on the UNet's output, the dry run's reading),
and the first Euler step multiplies that by its sigma of about 700. The
overall pipeline's candidates split 3 + 2, so its batches shrink the same
way: the same tolerances on its videos, and 1e-6 on its scores.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import jax
import jax.numpy as jnp

from ctrlv_tpu.pipelines import StableVideoControlPipeline as JaxPipeline
from ctrlv_tpu_torch.models import (
    AutoencoderKLTemporalDecoder,
    CLIPVisionConfig,
    CLIPVisionModelWithProjection,
    ControlNetSpatioTemporal,
    UNetSpatioTemporalConditionModel,
    UNetSTConfig,
    VAEConfig,
)
from ctrlv_tpu_torch.parallel.launch import spawn
from test_torch_convert import load, tiny_jax_models
from test_torch_sampler import jax_draws
import torch_dist_cases as cases

torch.set_num_threads(1)
RANKS_S = 300  # the spawned ranks' limit: ended and failed after it

F, H, W = 3, 16, 16
KW = dict(num_frames=F, num_inference_steps=2, min_guidance_scale=1.0,
          max_guidance_scale=3.0, decode_chunk_size=2)


def _outputs(out, world):
    # files this test's ranks wrote, numpy arrays among them
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def test_box2video_frame_sharded_matches_jax(tmp_path):
    m = tiny_jax_models(F, (H, W))
    rng = np.random.default_rng(7)
    image = rng.uniform(-1, 1, (1, H, W, 3)).astype(np.float32)
    cond = rng.uniform(-1, 1, (1, F, H, W, 3)).astype(np.float32)
    scale = VAEConfig.tiny().spatial_scale
    noise, lat = jax_draws(3, image.shape, (1, F, H // scale, W // scale, 4))

    ucfg = UNetSTConfig.tiny()
    modules = [load(UNetSpatioTemporalConditionModel(ucfg), m["unet_params"]),
               load(ControlNetSpatioTemporal(ucfg), m["ctrl_params"]),
               load(AutoencoderKLTemporalDecoder(VAEConfig.tiny()), m["vae_params"]),
               load(CLIPVisionModelWithProjection(CLIPVisionConfig.tiny()), m["clip_params"],
                    "image_encoder")]
    torch.save(dict(state_dicts=[mod.state_dict() for mod in modules],
                    image=torch.from_numpy(image), cond=torch.from_numpy(cond),
                    image_noise=noise, latents=lat, kwargs=KW), tmp_path / "box2video.pt")
    with ThreadPoolExecutor(1) as pool:  # the two ranks run in processes of their own
        ranks = pool.submit(spawn, cases.pipeline_case, 2, "cpu",
                            (str(tmp_path), str(tmp_path / "two"), 1, 2), store_dir=str(tmp_path),
                            timeout=RANKS_S)
        jax_pipe = JaxPipeline(m["unet"], m["unet_params"], m["ctrl"], m["ctrl_params"],
                               m["vae"], m["vae_params"], m["clip"], m["clip_params"])
        ref = np.asarray(jax_pipe(jnp.asarray(image), jnp.asarray(cond),
                                  rng=jax.random.PRNGKey(3), **KW))
        cases.pipeline_case(0, 1, str(tmp_path), str(tmp_path / "one"), 1, 1)
        ranks.result()
    (one,) = _outputs(tmp_path / "one", 1)
    two = _outputs(tmp_path / "two", 2)
    assert np.ptp(ref) > 0.05  # the reference is not a constant clip
    for out in two:
        assert out.shape == (1, F, H, W, 3)
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-3)
        torch.testing.assert_close(out, one, rtol=0, atol=1e-3)
        assert ((out - one).norm() / one.norm()).item() < 5e-4
    assert torch.equal(two[0], two[1])


def test_overall_data_sharded_chooses_as_one_rank(tmp_path):
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, cases.overall_case, 2, "cpu", (str(tmp_path / "two"), 2, 1),
                            store_dir=str(tmp_path), timeout=RANKS_S)
        cases.overall_case(0, 1, str(tmp_path / "one"), 1, 1)
        ranks.result()
    (one,) = _outputs(tmp_path / "one", 1)
    for run in _outputs(tmp_path / "two", 2):
        assert run["best_guidance"] == one["best_guidance"]
        for k in ("miou", "ap", "ar", "miou_first_last"):
            assert abs(run[k] - one[k]) <= 1e-6, k
        for k in ("video", "bbox_video"):
            np.testing.assert_allclose(run[k], one[k], rtol=0, atol=1e-3)
            assert np.linalg.norm(run[k] - one[k]) / np.linalg.norm(one[k]) < 5e-4, k
