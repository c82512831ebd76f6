"""What the port's tools share: building the models and loading their weights.

Counterpart of ``tools/common.py``. The tiny or the full (SVD-XT) configs,
a seeded init, then, where ``cfg.pretrained_model_name_or_path`` is a local
diffusers directory, its ``unet/``, ``vae/`` and ``image_encoder/`` loaded
strictly by ``train.hf_import.load_hf_component``; the ControlNet starts as
a copy of the (loaded) UNet's shared weights. As in the JAX tool,
``pretrained_bbox_model`` is not read and a ``control_net/`` directory is
not loaded. The modules are cast to ``cfg.compute_dtype`` and live on the
device: ``device``, else ``cfg.device``, else the card.
"""

from __future__ import annotations

import os

import torch

from ..models import (
    AutoencoderKLTemporalDecoder,
    CLIPVisionConfig,
    CLIPVisionModelWithProjection,
    ControlNetSpatioTemporal,
    UNetSpatioTemporalConditionModel,
    UNetSTConfig,
    VAEConfig,
    controlnet_from_unet,
)
from ..pipelines.common import resolve_device
from ..train.hf_import import load_hf_component
from ..utils.config import Config

COMPONENTS = (("unet", "unet"), ("vae", "vae"), ("clip", "image_encoder"))


def build_models(cfg: Config, tiny: bool = False, with_controlnet: bool = False, device=None):
    """{unet, vae, clip[, ctrl], unet_cfg, vae_cfg, clip_cfg, device}."""
    if cfg.mesh_frame > 1 or (cfg.mesh_data or 1) > 1:
        raise NotImplementedError(
            f"mesh_data={cfg.mesh_data}, mesh_frame={cfg.mesh_frame}: the port runs on one card "
            "(multi-card is ROADMAP item 15)")
    device = resolve_device(device if device is not None else cfg.device)
    if tiny:
        ucfg, vcfg, ccfg = UNetSTConfig.tiny(), VAEConfig.tiny(), CLIPVisionConfig.tiny()
    else:
        ucfg, vcfg, ccfg = UNetSTConfig(), VAEConfig(), CLIPVisionConfig()

    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []), device:
        torch.manual_seed(cfg.seed)
        models = dict(
            unet=UNetSpatioTemporalConditionModel(
                ucfg, gradient_checkpointing=cfg.enable_gradient_checkpointing),
            vae=AutoencoderKLTemporalDecoder(vcfg),
            clip=CLIPVisionModelWithProjection(ccfg),
        )
        if with_controlnet:
            models["ctrl"] = ControlNetSpatioTemporal(
                ucfg, gradient_checkpointing=cfg.enable_gradient_checkpointing)
    for key in models:
        models[key] = models[key].to(cfg.compute_dtype).eval()

    model_dir = cfg.pretrained_model_name_or_path
    if os.path.isdir(model_dir):
        for key, sub in COMPONENTS:
            comp_dir = os.path.join(model_dir, sub)
            if os.path.isdir(comp_dir):
                dropped = load_hf_component(comp_dir, models[key], strict=True)
                print(f"loaded HF weights: {sub}" + (f" (dropped {dropped})" if dropped else ""))
    if with_controlnet:
        controlnet_from_unet(models["unet"], models["ctrl"])
    return dict(models, unet_cfg=ucfg, vae_cfg=vcfg, clip_cfg=ccfg, device=device)
