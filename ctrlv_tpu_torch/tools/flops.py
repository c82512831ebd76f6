"""FLOP counts of the port's models, pipelines and training micro-steps.

The role of the JAX package's ``tools/flops_report.py`` and of XLA's
``cost_analysis()`` in its ``tools/bench_train.py``. Counted by
``torch.utils.flop_counter.FlopCounterMode`` on modules built on the ``meta``
device (no memory, no arithmetic: a full-width count takes seconds on a CPU;
the small test configs count faster on the CPU itself, where an op of a few
elements costs less than a ``meta`` op's shape rules in Python) under
``plain_kernels()``: the hand-written kernels are calls the counter
does not see, so their plain versions stand in for them. The counter counts
matrix products, convolutions and attention, not elementwise work, which XLA's
counts also hold; so these counts come out a few per cent under XLA's.

The pipelines draw with generators and read scalars back, so they do not run
on ``meta``: a request is counted by component, each component through the
function the pipeline calls it with, times the pipeline's call count. A
training micro-step runs the real step function on ``meta``, forward and
backward under the models' block checkpointing, so the recompute is counted.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..models import (
    AutoencoderKLTemporalDecoder,
    CLIPVisionConfig,
    CLIPVisionModelWithProjection,
    ControlNetSpatioTemporal,
    UNetSpatioTemporalConditionModel,
    UNetSTConfig,
    VAEConfig,
)
from ..ops import _launch
from ..pipelines import GUIDANCE_PAIRS
from ..pipelines.common import (
    decode_latents,
    encode_clip_image,
    encode_vae_image,
    encode_vae_video,
)

META = torch.device("meta")
# The card's dense bf16 tensor-core peak (NVIDIA H100 SXM), the denominator of MFU.
PEAK_BF16 = 989e12
# The four kinds of training micro-step; a regime's optimizer does not change its count.
TRAIN_KINDS = ("controlnet", "temporal", "lora", "full")


def count_flops(fn, *args, **kwargs) -> int:
    """FLOPs of ``fn(*args, **kwargs)`` with every kernel's plain version."""
    with _launch.plain_kernels(), FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return counter.get_total_flops()


def model_configs(tiny: bool = False) -> tuple:
    """(UNet/ControlNet, VAE, CLIP) configs: SVD-XT's, or for ``tiny`` the
    UNet's micro config (two levels, one layer a block, every block kind) and
    the tiny VAE and CLIP, small enough for the CPU tests."""
    if tiny:
        return UNetSTConfig.micro(), VAEConfig.tiny(), CLIPVisionConfig.tiny()
    return UNetSTConfig(), VAEConfig(), CLIPVisionConfig()


def counting_models(tiny: bool = False, stage1: bool = False, device=META, **net_kw) -> dict:
    """{unet, ctrl, vae, clip[, unet1]} in bf16 on ``device`` (weights
    uninitialised); ``net_kw`` goes to the UNet and the ControlNet
    (``gradient_checkpointing``, ``remat_granularity``); ``unet1`` is the
    stage-1 (frames-major) UNet."""
    ucfg, vcfg, ccfg = model_configs(tiny)
    with torch.device(device):
        models = dict(unet=UNetSpatioTemporalConditionModel(ucfg, **net_kw),
                      ctrl=ControlNetSpatioTemporal(ucfg, **net_kw),
                      vae=AutoencoderKLTemporalDecoder(vcfg),
                      clip=CLIPVisionModelWithProjection(ccfg))
        if stage1:
            models["unet1"] = UNetSpatioTemporalConditionModel(ucfg,
                                                               temporal_layout="frames_major")
    return {k: m.to(torch.bfloat16).eval().requires_grad_(False) for k, m in models.items()}


def _zeros_on(net):
    """zeros(*shape, dtype=f32) on ``net``'s device."""
    device = next(net.parameters()).device
    return lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=device)


def _step_inputs(unet, batch: int, frames: int, h: int, w: int):
    cfg, zeros = unet.config, _zeros_on(unet)
    return (zeros(batch, frames, h, w, cfg.in_channels), zeros(),
            zeros(batch, 1, cfg.cross_attention_dim), zeros(batch, 3))


def unet_step_flops(unet, batch: int, frames: int, h: int, w: int) -> int:
    """One UNet forward at a (CFG) batch of ``batch`` clips of h x w latents."""
    with torch.no_grad():
        return count_flops(unet, *_step_inputs(unet, batch, frames, h, w))


def controlnet_step_flops(ctrl, batch: int, frames: int, h: int, w: int) -> int:
    cond = _zeros_on(ctrl)(batch, frames, h, w, ctrl.config.in_channels // 2)
    with torch.no_grad():
        return count_flops(ctrl, *_step_inputs(ctrl, batch, frames, h, w), cond)


def clip_flops(clip, batch: int, height: int, width: int) -> int:
    """The CLIP embedding of ``batch`` first frames, as the samplers take it."""
    with torch.no_grad():
        return count_flops(encode_clip_image, clip, _zeros_on(clip)(batch, height, width, 3),
                           True)


def vae_decode_flops(vae, batch: int, frames: int, h: int, w: int, chunk,
                     max_frames=None) -> int:
    """``decode_latents`` of ``batch`` clips of ``frames`` latents, all its calls."""
    lat = _zeros_on(vae)(batch, frames, h, w, vae.config.latent_channels)
    with torch.no_grad():
        return count_flops(decode_latents, vae, lat, vae.config.scaling_factor, chunk,
                           max_frames)


def sampler_flops(models: dict, batch: int, frames: int, height: int, width: int, steps: int,
                  chunk, max_frames=None, unet: str = "unet", control: bool = True) -> dict:
    """One CFG sampler call by component: CLIP, the VAE encodes (the first
    frame and, for the ControlNet or the bbox frames, the clip), ``steps``
    denoise steps at batch 2 x ``batch``, the chunked decode. Counts are
    FLOPs; "total" sums them."""
    vae, scale, zeros = models["vae"], models["vae"].config.spatial_scale, _zeros_on(models["vae"])
    h, w = height // scale, width // scale
    with torch.no_grad():
        enc = (count_flops(encode_vae_image, vae, zeros(batch, height, width, 3),
                           zeros(batch, height, width, 3), 0.02, True)
               + count_flops(encode_vae_video, vae, zeros(batch, frames, height, width, 3), True))
    out = {"clip": clip_flops(models["clip"], batch, height, width), "vae_encode": enc,
           "unet": steps * unet_step_flops(models[unet], 2 * batch, frames, h, w)}
    if control:
        out["controlnet"] = steps * controlnet_step_flops(models["ctrl"], 2 * batch, frames,
                                                          h, w)
    out["vae_decode"] = vae_decode_flops(vae, batch, frames, h, w, chunk, max_frames)
    out["total"] = sum(out.values())
    return out


def box2video_flops(models: dict, frames: int = 25, height: int = 320, width: int = 512,
                    steps: int = 25, chunk=8, max_frames=None) -> dict:
    """A Box2Video request (``StableVideoControlPipeline``), by component."""
    return sampler_flops(models, 1, frames, height, width, steps, chunk, max_frames)


def overall_flops(models: dict, frames: int = 25, height: int = 320, width: int = 512,
                  stage1_steps: int = 30, stage2_steps: int = 25, chunk=8,
                  max_frames=None) -> dict:
    """An ``OverallPipeline`` request: stage 1, all five candidates in one
    batch through ``models["unet1"]``, then a Box2Video clip. The select
    does no matrix work."""
    stage1 = sampler_flops(models, len(GUIDANCE_PAIRS), frames, height, width, stage1_steps,
                           chunk, max_frames, unet="unet1", control=False)
    stage2 = box2video_flops(models, frames, height, width, stage2_steps, chunk, max_frames)
    return {"stage1": stage1, "stage2": stage2, "total": stage1["total"] + stage2["total"]}


class _NoUpdate:
    """An optimizer that moves nothing: its work is elementwise, which the
    counter does not count."""

    def init(self, params):
        return {}

    def update(self, grads, state, params):
        return state


def train_micro_step_flops(kind: str, frames: int = 25, height: int = 320, width: int = 512,
                           encode_chunk=5, remat_granularity: str = "block",
                           tiny: bool = False, device=META) -> int:
    """One training micro-step of a regime ``kind`` (``TRAIN_KINDS``) on one
    clip: the VAE encodes and CLIP without a graph, then the trained network(s)
    forward and backward with block checkpointing (``remat_granularity``),
    the recomputed forwards included. The stage-1 kinds train the UNet as the
    JAX bench does (no bbox prediction): its temporal transformer blocks, LoRA
    adapters of rank 4 on to_q/k/v/out.0, or every parameter."""
    from ..train import (
        init_train_state,
        lora_init,
        make_controlnet_train_step,
        make_svd_train_step,
        split_trainable,
        temporal_blocks_predicate,
    )

    if kind not in TRAIN_KINDS:
        raise ValueError(f"{kind!r} is not one of {TRAIN_KINDS}")
    m = counting_models(tiny=tiny, device=device, gradient_checkpointing=True,
                        remat_granularity=remat_granularity)
    scale, zeros = m["vae"].config.spatial_scale, _zeros_on(m["vae"])
    lat = (height // scale, width // scale, m["vae"].config.latent_channels)
    clips = zeros(1, frames, height, width, 3)
    draws = {"latent_noise": zeros(frames, *lat), "init_noise": zeros(1, *lat),
             "noise": zeros(1, frames, *lat), "sigma_idx": zeros(1, dtype=torch.long),
             "dropout_u": zeros(1) + 0.9}  # keeps both conditionings
    tx = _NoUpdate()
    kw = dict(conditioning_dropout_prob=0.1, encode_chunk=encode_chunk, device=device)
    if kind == "controlnet":
        m["ctrl"].train().requires_grad_(True)
        step = make_controlnet_train_step(m["unet"], m["ctrl"], m["vae"], m["clip"], tx, **kw)
        state = init_train_state(m["ctrl"], tx)
        draws["cond_noise"] = zeros(frames, *lat)
    else:
        unet = m["unet"].train()
        step = make_svd_train_step(unet, m["vae"], m["clip"], tx, partitioned=kind == "temporal",
                                   lora=kind == "lora", **kw)
        if kind == "temporal":
            params = split_trainable(unet, temporal_blocks_predicate)
        elif kind == "lora":
            params = lora_init(torch.Generator().manual_seed(42), unet, rank=4)
        else:
            params = unet.requires_grad_(True)
        state = init_train_state(params, tx)
    return count_flops(step, state, clips, clips, draws=draws)
