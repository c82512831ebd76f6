"""The port's Box2Video sampler against the JAX package's, end to end.

The tiny StableVideoControlPipeline runs in JAX and in the port with the
same seeded weights (converted, strict) and the same inputs, for 2 Euler
steps with CFG 1 -> 3 and a chunked decode. The JAX sampler draws its noise
inside its program; the test draws the same numbers with jax.random
(split, then normal, as ctrlv_tpu/pipelines/video_control.py does) and
hands them to the port as image_noise and latents.

Tolerance: f32 on the CPU on both sides. The initial latents are scaled by
init_noise_sigma ~ 700 and pass through CLIP, two VAE encodes, two
ControlNet+UNet steps and the decode, each with its own order of sums;
frames in [0, 1] agree to 1e-3 absolute.
"""

import numpy as np
import pytest
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
from ctrlv_tpu_torch.pipelines import StableVideoControlPipeline
from test_torch_convert import load, tiny_jax_models

torch.set_num_threads(1)

F, H, W = 3, 16, 16
KW = dict(num_frames=F, num_inference_steps=2, min_guidance_scale=1.0,
          max_guidance_scale=3.0, decode_chunk_size=2)


@pytest.fixture(scope="module")
def pipes():
    m = tiny_jax_models(F, (H, W))
    jax_pipe = JaxPipeline(
        m["unet"], m["unet_params"], m["ctrl"], m["ctrl_params"],
        m["vae"], m["vae_params"], m["clip"], m["clip_params"],
    )
    port_pipe = StableVideoControlPipeline(
        load(UNetSpatioTemporalConditionModel(UNetSTConfig.tiny()), m["unet_params"]),
        load(ControlNetSpatioTemporal(UNetSTConfig.tiny()), m["ctrl_params"]),
        load(AutoencoderKLTemporalDecoder(VAEConfig.tiny()), m["vae_params"]),
        load(CLIPVisionModelWithProjection(CLIPVisionConfig.tiny()), m["clip_params"],
             "image_encoder"),
        device="cpu",
    )
    return jax_pipe, port_pipe


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    image = rng.uniform(-1, 1, (1, H, W, 3)).astype(np.float32)
    cond = rng.uniform(-1, 1, (1, F, H, W, 3)).astype(np.float32)
    return image, cond


def jax_draws(seed, image_shape, latent_shape):
    """The draws the JAX sampler makes from PRNGKey(seed)."""
    rng_noise, rng_lat = jax.random.split(jax.random.PRNGKey(seed))
    noise = jax.random.normal(rng_noise, image_shape, jnp.float32)
    lat = jax.random.normal(rng_lat, latent_shape, jnp.float32)
    return torch.from_numpy(np.asarray(noise)), torch.from_numpy(np.asarray(lat))


def test_sampler_matches_jax(pipes, inputs):
    jax_pipe, port_pipe = pipes
    image, cond = inputs
    ref = np.asarray(jax_pipe(jnp.asarray(image), jnp.asarray(cond),
                              rng=jax.random.PRNGKey(3), **KW))
    scale = VAEConfig.tiny().spatial_scale
    noise, lat = jax_draws(3, image.shape, (1, F, H // scale, W // scale, 4))
    out = port_pipe(torch.from_numpy(image), torch.from_numpy(cond),
                    image_noise=noise, latents=lat, **KW).numpy()
    assert out.shape == (1, F, H, W, 3) and np.isfinite(out).all()
    assert out.min() >= 0.0 and out.max() <= 1.0
    assert np.ptp(ref) > 0.05  # the reference is not a constant clip
    np.testing.assert_allclose(out, ref, atol=1e-3)


def test_sampler_seeds_from_generator(pipes, inputs):
    """Without injected draws the port draws from its generator: the same
    seed gives the same clip, another seed another clip."""
    _, port_pipe = pipes
    image, cond = (torch.from_numpy(x) for x in inputs)
    kw = dict(KW, num_inference_steps=1)

    def run(seed):
        return port_pipe(image, cond, generator=torch.Generator().manual_seed(seed), **kw)

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)
    lat = port_pipe(image, cond, generator=torch.Generator().manual_seed(1),
                    output_type="latent", **kw)
    scale = VAEConfig.tiny().spatial_scale
    assert lat.shape == (1, F, H // scale, W // scale, 4) and lat.dtype == torch.float32
