"""The port's stage-1 sampler and two-stage overall pipeline against the JAX
package's, end to end, and the pieces between the stages bit for bit.

The micro UNet (two blocks, one layer), the tiny VAE and the tiny CLIP run
in JAX and in the port with the same seeded weights (converted, strict) and
the same inputs, for 2 Euler steps. The JAX pipelines draw their noise
inside their programs; the test draws the same numbers with jax.random
(the same splits in the same order) and hands them to the port.

Tolerance: f32 on the CPU on both sides. Latents start at
init_noise_sigma ~ 700 and pass through CLIP, the VAE encodes and two UNet
steps, each with its own order of sums: final latents agree to 1e-3
absolute, frames in [0, 1] to 1e-3. The cleanup and the IoU are
comparisons and counts of the same f32 values: equal bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctrlv_tpu.metrics.iou import binary_mask_iou as jax_binary_mask_iou
from ctrlv_tpu.metrics.iou import binary_mask_iou_batch as jax_binary_mask_iou_batch
from ctrlv_tpu.models import (
    AutoencoderKLTemporalDecoder as JaxVAE,
    CLIPVisionConfig as JaxCLIPConfig,
    CLIPVisionModelWithProjection as JaxCLIP,
    ControlNetSpatioTemporal as JaxControlNet,
    UNetSpatioTemporalConditionModel as JaxUNet,
    UNetSTConfig as JaxUNetConfig,
    VAEConfig as JaxVAEConfig,
)
from ctrlv_tpu.pipelines import StableVideoControlPipeline as JaxControlPipeline
from ctrlv_tpu.pipelines.overall import OverallPipeline as JaxOverallPipeline
from ctrlv_tpu.pipelines.overall import darkness_cleanup as jax_darkness_cleanup
from ctrlv_tpu.pipelines.video_diffusion import VideoDiffusionPipeline as JaxDiffusionPipeline
from ctrlv_tpu_torch.metrics import binary_mask_iou, binary_mask_iou_batch
from ctrlv_tpu_torch.models import (
    AutoencoderKLTemporalDecoder,
    CLIPVisionConfig,
    CLIPVisionModelWithProjection,
    ControlNetSpatioTemporal,
    UNetSpatioTemporalConditionModel,
    UNetSTConfig,
    VAEConfig,
)
from ctrlv_tpu_torch.pipelines import (
    GUIDANCE_PAIRS,
    OverallPipeline,
    StableVideoControlPipeline,
    VideoDiffusionPipeline,
    darkness_cleanup,
)
from ctrlv_tpu_torch.pipelines import common
from test_torch_convert import load, seeded_params

torch.set_num_threads(1)

F, H, W = 4, 16, 16
N = len(GUIDANCE_PAIRS)
STEPS = 2
SCALE = VAEConfig.tiny().spatial_scale
LATENT = (F, H // SCALE, W // SCALE, 4)


def _adversarial_clip(rng, f=5, h=8, w=8):
    frames = rng.uniform(0.0, 1.0, size=(f, h, w, 3)).astype(np.float32)
    # dark pixels straddling the threshold: channel sums of 49/255, 50/255, 51/255
    for j, s in enumerate((49.0, 50.0, 51.0)):
        frames[0, 0, j] = np.float32(s / 255.0 / 3.0)
    # a mostly dark frame (most pixels zeroed, survives the interior kill)
    frames[2] = rng.uniform(0.0, 0.05, size=(h, w, 3)).astype(np.float32)
    frames[2, 0, 0] = 0.9  # a bright box pixel that must survive the cleanup
    # an all-bright interior frame (triggers the frame kill)
    frames[3] = rng.uniform(0.5, 1.0, size=(h, w, 3)).astype(np.float32)
    return frames


def test_darkness_cleanup_bit_for_bit():
    cands = np.stack([_adversarial_clip(np.random.default_rng(s)) for s in range(5)])
    ref = np.asarray(jax_darkness_cleanup(jnp.asarray(cands)))
    out = darkness_cleanup(torch.from_numpy(cands)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert out[0, 3].sum() == 0 and out[0, 2].sum() > 0  # bright interior killed, dark one kept
    assert out[0, 0, 0, 0].sum() == 0 and out[0, 0, 0, 2].sum() > 0  # 49 zeroed, 51 kept


def test_binary_mask_iou_bit_for_bit():
    rng = np.random.default_rng(1)
    gt = ((rng.uniform(0, 1, size=(5, 8, 8, 3)) > 0.7) * 255.0).astype(np.float32)
    cands = np.stack([_adversarial_clip(np.random.default_rng(s)) for s in range(5)])
    cand_u8 = np.floor(np.asarray(jax_darkness_cleanup(jnp.asarray(cands))) * 255.0)
    ref = np.asarray(jax_binary_mask_iou_batch(jnp.asarray(gt), jnp.asarray(cand_u8)))
    out = binary_mask_iou_batch(torch.from_numpy(gt), torch.from_numpy(cand_u8)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert binary_mask_iou(gt, cand_u8[2]) == jax_binary_mask_iou(gt, cand_u8[2])
    # empty masks score 1 on both sides
    zero = np.zeros_like(gt)
    empty = binary_mask_iou_batch(torch.from_numpy(zero), torch.from_numpy(zero)[None]).numpy()
    np.testing.assert_array_equal(empty, np.ones((1, 3), np.float32))
    assert binary_mask_iou(zero, zero) == (1.0, 1.0, 1.0)


@pytest.fixture(scope="module")
def models():
    """JAX micro models with seeded params and the port's, loaded from them."""
    ucfg = JaxUNetConfig.micro(num_frames=F)
    junet, jctrl = JaxUNet(config=ucfg), JaxControlNet(config=ucfg)
    jvae, jclip = JaxVAE(config=JaxVAEConfig.tiny()), JaxCLIP(config=JaxCLIPConfig.tiny())
    sample = jnp.zeros((1,) + LATENT[:3] + (8,))
    cond = jnp.zeros((1,) + LATENT)
    enc, tids, ts = jnp.zeros((1, 1, 48)), jnp.zeros((1, 3)), jnp.asarray(0.5)
    size = JaxCLIPConfig.tiny().image_size
    p = dict(
        unet1=seeded_params(junet, 20, sample, ts, enc, tids),
        unet2=seeded_params(junet, 21, sample, ts, enc, tids),
        ctrl=seeded_params(jctrl, 22, sample, ts, enc, tids, cond),
        vae=seeded_params(jvae, 23, jnp.zeros((1, H, W, 3))),
        clip=seeded_params(jclip, 24, jnp.zeros((1, size, size, 3))),
    )
    jax_bbox = JaxDiffusionPipeline(junet, p["unet1"], jvae, p["vae"], jclip, p["clip"])
    jax_ctrl = JaxControlPipeline(junet, p["unet2"], jctrl, p["ctrl"], jvae, p["vae"], jclip,
                                  p["clip"])
    micro = UNetSTConfig.micro()
    vae = load(AutoencoderKLTemporalDecoder(VAEConfig.tiny()), p["vae"])
    clip = load(CLIPVisionModelWithProjection(CLIPVisionConfig.tiny()), p["clip"], "image_encoder")
    bbox = VideoDiffusionPipeline(
        load(UNetSpatioTemporalConditionModel(micro, temporal_layout="frames_major"), p["unet1"]),
        vae, clip, device="cpu")
    ctrl = StableVideoControlPipeline(
        load(UNetSpatioTemporalConditionModel(micro), p["unet2"]),
        load(ControlNetSpatioTemporal(micro), p["ctrl"]), vae, clip, device="cpu")
    return dict(jax_bbox=jax_bbox, jax_ctrl=jax_ctrl, bbox=bbox, ctrl=ctrl, vae=vae)


@pytest.fixture(scope="module")
def request_inputs():
    """A first frame and bbox frames in [-1, 1]: a dark clip with one bright
    box moving across it."""
    rng = np.random.default_rng(7)
    image = rng.uniform(-1, 1, (H, W, 3)).astype(np.float32)
    bbox = np.full((F, H, W, 3), -1.0, np.float32)
    for f in range(F):
        bbox[f, 3:9, 2 + 2 * f : 8 + 2 * f] = (1.0, 0.2, -0.4)
    return image, bbox


def jax_draws(key, batch):
    """The draws a JAX sampler makes from ``key``: split, image noise, latents."""
    rng_noise, rng_lat = jax.random.split(key)
    noise = jax.random.normal(rng_noise, (batch, H, W, 3), jnp.float32)
    lat = jax.random.normal(rng_lat, (batch,) + LATENT, jnp.float32)
    return torch.from_numpy(np.array(noise)), torch.from_numpy(np.array(lat))


def test_stage1_latents_match_jax(models, request_inputs):
    """VideoDiffusionPipeline with bbox frames, the five guidance pairs as
    one batch, final latents."""
    image, bbox = request_inputs
    images = np.tile(image[None], (N, 1, 1, 1))
    bboxes = np.tile(bbox[None], (N, 1, 1, 1, 1))
    kw = dict(num_frames=F, num_inference_steps=STEPS, num_cond_bbox_frames=2,
              output_type="latent")
    key = jax.random.PRNGKey(3)
    ref = np.asarray(models["jax_bbox"](
        jnp.asarray(images), bbox_images=jnp.asarray(bboxes), rng=key,
        guidance_minmax=jnp.asarray(GUIDANCE_PAIRS, jnp.float32), **kw))
    noise, lat = jax_draws(key, N)
    out = models["bbox"](
        torch.from_numpy(images), torch.from_numpy(bboxes), image_noise=noise, latents=lat,
        guidance_minmax=torch.tensor(GUIDANCE_PAIRS), **kw).numpy()
    assert out.shape == (N,) + LATENT and np.isfinite(out).all()
    assert np.abs(ref[0] - ref[-1]).max() > 1e-2  # the guidance pairs give different clips
    np.testing.assert_allclose(out, ref, atol=1e-3)


def test_overall_matches_jax(models, request_inputs):
    image, bbox = request_inputs
    kw = dict(num_frames=F, stage1_steps=STEPS, stage2_steps=STEPS, decode_chunk_size=2,
              num_cond_bbox_frames=2)
    key = jax.random.PRNGKey(5)
    ref = JaxOverallPipeline(models["jax_bbox"], models["jax_ctrl"])(
        jnp.asarray(image), jnp.asarray(bbox), key, **kw)
    rng1, rng2 = jax.random.split(key)
    out = OverallPipeline(models["bbox"], models["ctrl"])(
        torch.from_numpy(image), torch.from_numpy(bbox),
        stage1_noise=jax_draws(rng1, N), stage2_noise=jax_draws(rng2, 1), **kw)
    assert set(out) == set(ref)
    assert out["best_guidance"] == ref["best_guidance"]  # the same candidate wins
    assert out["video"].shape == (F, H, W, 3) and out["bbox_video"].shape == (F, H, W, 3)
    assert out["video"].min() >= 0.0 and out["video"].max() <= 1.0
    np.testing.assert_allclose(out["video"], ref["video"], atol=1e-3)
    np.testing.assert_allclose(out["bbox_video"], ref["bbox_video"], atol=1e-3)
    for name in ("miou", "ap", "ar", "miou_first_last", "ap_first_last", "ar_first_last"):
        assert isinstance(out[name], float)
        # a pixel within 1e-3 of the darkness threshold may fall on either side
        assert abs(out[name] - ref[name]) <= 0.02, name


def test_overall_draws_from_one_generator(models, request_inputs):
    """Without injected draws both stages draw from the one generator: the
    same seed gives the same result."""
    image, bbox = (torch.from_numpy(x) for x in request_inputs)
    pipe = OverallPipeline(models["bbox"], models["ctrl"])
    kw = dict(num_frames=F, stage1_steps=1, stage2_steps=1, decode_chunk_size=2,
              max_decode_frames=2)

    def run(seed):
        return pipe(image, bbox, generator=torch.Generator().manual_seed(seed), **kw)

    a, b, c = run(1), run(1), run(2)
    assert np.array_equal(a["video"], b["video"])
    assert not np.allclose(a["video"], c["video"])
    assert a["best_guidance"] in GUIDANCE_PAIRS


def test_decode_latents_bounded_equals_unbounded(models):
    """max_frames_per_call groups whole chunks into serial calls; the chunks
    themselves, and so the frames, stay the same."""
    rng = np.random.default_rng(9)
    lat = torch.from_numpy(rng.standard_normal((2, 19, 4, 4, 4)).astype(np.float32))
    vae = models["vae"]
    calls = []
    real = vae.decode
    vae.decode = lambda z, n=1: calls.append(z.shape[0]) or real(z, n)
    try:
        with torch.no_grad():
            ref = common.decode_latents(vae, lat, 0.18215, 4)
            n_unbounded = list(calls)
            calls.clear()
            out = common.decode_latents(vae, lat, 0.18215, 4, max_frames_per_call=8)
    finally:
        del vae.decode
    assert n_unbounded == [2 * 16, 2 * 3]  # all full chunks at once, then the remainder
    assert calls == [2 * 8, 2 * 8, 2 * 3]  # two chunks a call
    assert out.shape == (2, 19, 8, 8, 3)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)


def test_pipelines_refuse_to_fall_back_to_the_cpu(models):
    """device=None means the card. Without one the constructor raises; with
    device="cpu" a pipeline moves its inputs there and rejects a generator
    from elsewhere."""
    if torch.cuda.is_available():
        assert common.resolve_device(None).type == "cuda"
    else:
        for build in (
            lambda: VideoDiffusionPipeline(models["bbox"].unet, models["vae"],
                                           models["bbox"].image_encoder),
            lambda: StableVideoControlPipeline(models["ctrl"].unet, models["ctrl"].controlnet,
                                               models["vae"], models["ctrl"].image_encoder),
            lambda: VideoDiffusionPipeline(models["bbox"].unet, models["vae"],
                                           models["bbox"].image_encoder, device="cuda"),
        ):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build()
    assert models["bbox"].device == torch.device("cpu")
    assert OverallPipeline(models["bbox"], models["ctrl"]).device == torch.device("cpu")

    class ElsewhereGenerator:
        device = torch.device("meta")

    with pytest.raises(ValueError, match="generator"):
        common.check_generator(ElsewhereGenerator(), torch.device("cpu"))
    common.check_generator(torch.Generator(), torch.device("cpu"))
    ElsewhereGenerator.device = torch.device("cuda")  # no index: the current card
    common.check_generator(ElsewhereGenerator(), torch.device("cuda:0"))
    with pytest.raises(ValueError, match="generator"):
        common.check_generator(ElsewhereGenerator(), torch.device("cpu"))
    common.check_generator(None, torch.device("cpu"))
