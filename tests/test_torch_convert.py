"""The port's models against the JAX package's, with the same weights.

The tiny UNet, ControlNet, VAE and CLIP of tests/helpers.py get seeded
params (every leaf random, see ``seeded_params``), which are flattened,
converted with ctrlv_tpu_torch.convert and loaded into the port's modules
with load_state_dict(strict=True). The same seeded numpy inputs then go
through both forwards in f32.

Tolerance: both sides compute in f32 on the CPU; they differ in the order
of sums (matmul and conv blocking, norm statistics) and in the gelu (the
JAX package's polynomial erf is within 1.5e-7 of torch's), so the outputs
agree to a few f32 ulps of the activations' scale. Each check is
atol = rtol = 1e-4 on outputs of order 1.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from ctrlv_tpu.models.clip_vision import clip_preprocess as jax_clip_preprocess
from ctrlv_tpu.models.controlnet import controlnet_params_from_unet
from ctrlv_tpu_torch.convert import flax_to_state_dict
from ctrlv_tpu_torch.models import (
    AutoencoderKLTemporalDecoder,
    CLIPVisionConfig,
    CLIPVisionModelWithProjection,
    ControlNetSpatioTemporal,
    UNetSpatioTemporalConditionModel,
    UNetSTConfig,
    VAEConfig,
    clip_preprocess,
    controlnet_from_unet,
)
from helpers import build_tiny_models

torch.set_num_threads(1)

F, H, W = 3, 32, 32
ATOL = RTOL = 1e-4


def flat(params):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}


def load(module, params, component=None):
    module.load_state_dict(flax_to_state_dict(flat(params), component), strict=True)
    return module.eval()


def seeded_params(module, seed, *init_args):
    """The module's JAX param tree with every leaf drawn from a seeded numpy
    generator: kernels ~ N(0, 1/fan_in), norm scales ~ 1 + 0.1 N(0, 1), all
    else ~ 0.1 N(0, 1). Only the tree's shapes come from flax (traced, not
    compiled), and no leaf is left at a trivial init (zero convs, unit norms)."""
    shapes = jax.eval_shape(lambda k: module.init(k, *init_args), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, x):
        name = path[-1].key
        if name == "kernel":
            std = 1.0 / np.sqrt(np.prod(x.shape[:-1]))
        elif name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        else:
            std = 0.1
        return (std * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def tiny_jax_models(num_frames, image_hw):
    """The tiny JAX models of tests/helpers.py with seeded params."""
    m = build_tiny_models(num_frames=num_frames, image_hw=image_hw, components=())
    h, w = image_hw
    scale = m["vae_cfg"].spatial_scale
    sample = jnp.zeros((1, num_frames, h // scale, w // scale, 8))
    cond = jnp.zeros((1, num_frames, h // scale, w // scale, 4))
    enc = jnp.zeros((1, 1, 48))
    tids = jnp.zeros((1, 3))
    ts = jnp.asarray(0.5)
    size = m["clip_cfg"].image_size
    m["unet_params"] = seeded_params(m["unet"], 10, sample, ts, enc, tids)
    m["ctrl_params"] = seeded_params(m["ctrl"], 11, sample, ts, enc, tids, cond)
    m["vae_params"] = seeded_params(m["vae"], 12, jnp.zeros((1, h, w, 3)))
    m["clip_params"] = seeded_params(m["clip"], 13, jnp.zeros((1, size, size, 3)))
    return m


@pytest.fixture(scope="module")
def jax_models():
    return tiny_jax_models(F, (H, W))


@pytest.fixture(scope="module")
def unet_inputs():
    rng = np.random.default_rng(0)
    scale = VAEConfig.tiny().spatial_scale
    sample = rng.standard_normal((2, F, H // scale, W // scale, 8)).astype(np.float32)
    cond = rng.standard_normal((2, F, H // scale, W // scale, 4)).astype(np.float32)
    enc = rng.standard_normal((2, 1, 48)).astype(np.float32)
    tids = np.asarray([[6.0, 127.0, 0.02]] * 2, np.float32)
    return sample, np.float32(0.7), enc, tids, cond


def t(x):
    return torch.from_numpy(np.asarray(x))


def nhwc(x):
    """The port's (B*F, C, h, w) residuals in the JAX layout."""
    return x.permute(0, 2, 3, 1).numpy()


def test_controlnet_matches_jax(jax_models, unet_inputs):
    sample, ts, enc, tids, cond = unet_inputs
    down_ref, mid_ref = jax.jit(jax_models["ctrl"].apply, static_argnames="conditioning_scale")(
        jax_models["ctrl_params"], sample, ts, enc, tids, cond, conditioning_scale=0.8
    )
    port = load(ControlNetSpatioTemporal(UNetSTConfig.tiny()), jax_models["ctrl_params"])
    with torch.no_grad():
        down, mid = port(t(sample), t(ts), t(enc), t(tids), t(cond), conditioning_scale=0.8)
    assert len(down) == len(down_ref)
    for a, b in zip(down, down_ref):
        np.testing.assert_allclose(nhwc(a), np.asarray(b), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(nhwc(mid), np.asarray(mid_ref), atol=ATOL, rtol=RTOL)


def test_unet_forward_with_residuals_matches_jax(jax_models, unet_inputs):
    """The UNet forward with random down and mid residuals injected, at the
    shapes the ControlNet gives them."""
    sample, ts, enc, tids, cond = unet_inputs
    with torch.no_grad():
        down, mid = ControlNetSpatioTemporal(UNetSTConfig.tiny())(
            t(sample), t(ts), t(enc), t(tids), t(cond)
        )
    rng = np.random.default_rng(1)
    down_np = [rng.standard_normal(nhwc(r).shape).astype(np.float32) for r in down]
    mid_np = rng.standard_normal(nhwc(mid).shape).astype(np.float32)
    ref = jax.jit(jax_models["unet"].apply)(
        jax_models["unet_params"], sample, ts, enc, tids,
        down_block_additional_residuals=tuple(down_np),
        mid_block_additional_residuals=mid_np,
    )
    unet = load(UNetSpatioTemporalConditionModel(UNetSTConfig.tiny()), jax_models["unet_params"])
    with torch.no_grad():
        out = unet(
            t(sample), t(ts), t(enc), t(tids),
            down_block_additional_residuals=tuple(t(r).permute(0, 3, 1, 2) for r in down_np),
            mid_block_additional_residuals=t(mid_np).permute(0, 3, 1, 2),
        )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_vae_encode_decode_match_jax(jax_models):
    vae, params = jax_models["vae"], jax_models["vae_params"]
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (F, H, W, 3)).astype(np.float32)
    port = load(AutoencoderKLTemporalDecoder(VAEConfig.tiny()), params)
    lat_ref = jax.jit(lambda p, x: vae.apply(p, x, method=vae.encode))(params, x)
    with torch.no_grad():
        lat = port.encode(t(x))
    np.testing.assert_allclose(lat.numpy(), np.asarray(lat_ref), atol=ATOL, rtol=RTOL)

    z = rng.standard_normal((2 * F,) + lat.shape[1:]).astype(np.float32)
    dec_ref = jax.jit(lambda p, z: vae.apply(p, z, F, method=vae.decode))(params, z)
    with torch.no_grad():
        dec = port.decode(t(z), F)
    np.testing.assert_allclose(dec.numpy(), np.asarray(dec_ref), atol=ATOL, rtol=RTOL)


def test_clip_forward_and_preprocess_match_jax(jax_models):
    rng = np.random.default_rng(3)
    cfg = CLIPVisionConfig.tiny()
    for hw in ((32, 48), (20, 28), (64, 20)):  # downscale, one axis kept, mixed
        img = rng.uniform(-1, 1, (2,) + hw + (3,)).astype(np.float32)
        ref = np.asarray(jax_clip_preprocess(jnp.asarray(img), cfg.image_size))
        out = clip_preprocess(t(img), cfg.image_size).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)

    pix = rng.standard_normal((2, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    ref = jax_models["clip"].apply(jax_models["clip_params"], pix)
    port = load(CLIPVisionModelWithProjection(cfg), jax_models["clip_params"], "image_encoder")
    with torch.no_grad():
        out = port(t(pix))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_clip_names_are_transformers_names(jax_models):
    sd = flax_to_state_dict(flat(jax_models["clip_params"]), "image_encoder")
    assert "vision_model.embeddings.position_embedding.weight" in sd
    assert "vision_model.encoder.layers.1.mlp.fc2.weight" in sd
    assert "visual_projection.weight" in sd
    unet_sd = flax_to_state_dict(flat(jax_models["unet_params"]))
    assert "time_embedding.linear_1.weight" in unet_sd
    key = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_out.0.weight"
    assert key in unet_sd


def test_controlnet_from_unet_matches_jax(jax_models):
    """The port's weight transfer copies what the JAX package's copies."""
    ref = controlnet_params_from_unet(jax_models["unet_params"], jax_models["ctrl_params"])
    unet = load(UNetSpatioTemporalConditionModel(UNetSTConfig.tiny()), jax_models["unet_params"])
    ctrl = load(ControlNetSpatioTemporal(UNetSTConfig.tiny()), jax_models["ctrl_params"])
    copied = controlnet_from_unet(unet, ctrl)
    expected = flax_to_state_dict(flat(ref))
    ours = ctrl.state_dict()
    assert copied == sum(k in unet.state_dict() for k in ours)
    for name, value in expected.items():
        assert torch.equal(ours[name], value), name
