"""What the port's tools share: building the models and loading their weights,
batches onto the device, and the trainers' training-state checkpoints.

Counterpart of ``tools/common.py``. The tiny or the full (SVD-XT) configs,
a seeded init in f32, then, where ``cfg.pretrained_model_name_or_path`` is a
local diffusers directory, its ``unet/``, ``vae/`` and ``image_encoder/``
loaded strictly by ``train.hf_import.load_hf_component``, still in f32; the
ControlNet starts as a copy of the (loaded) UNet's shared weights. As in the
JAX tool, ``pretrained_bbox_model`` is not read and a ``control_net/``
directory is not loaded. Only then are the modules cast to
``cfg.compute_dtype``: a trainer's f32 master weights start from the values
before that cast, as the JAX trainers' f32 parameters do, while a bf16 file
loaded through f32 and cast is the same bits as before. The modules live on
the device: ``device``, else ``cfg.device``, else the card.
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


def build_models(cfg: Config, tiny: bool = False, with_controlnet: bool = False, device=None,
                 masters=()):
    """{unet, vae, clip[, ctrl], unet_cfg, vae_cfg, clip_cfg, device, masters}.
    ``masters`` names components ("unet", "vae", "clip", "ctrl") whose f32
    state before the cast to ``compute_dtype`` comes back by parameter name
    under ``models["masters"][name]``: where a trainer's f32 master weights
    start."""
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
    unknown = set(masters) - set(models)
    if unknown:
        raise ValueError(f"masters names {sorted(unknown)}, not one of {sorted(models)}")

    model_dir = cfg.pretrained_model_name_or_path
    if os.path.isdir(model_dir):
        for key, sub in COMPONENTS:
            comp_dir = os.path.join(model_dir, sub)
            if os.path.isdir(comp_dir):
                dropped = load_hf_component(comp_dir, models[key], strict=True)
                print(f"loaded HF weights: {sub}" + (f" (dropped {dropped})" if dropped else ""))
    if with_controlnet:
        controlnet_from_unet(models["unet"], models["ctrl"])
    # the cast gives each parameter new data; these views keep the f32 data
    f32 = {key: {n: p.detach() for n, p in models[key].named_parameters()} for key in masters}
    for key in models:
        models[key] = models[key].to(cfg.compute_dtype).eval()
    return dict(models, unet_cfg=ucfg, vae_cfg=vcfg, clip_cfg=ccfg, device=device, masters=f32)


def batch_to_device(batch, device, dtype=torch.float32):
    """(clips, bbox frames) of a collated batch on ``device``; the clips
    stand in for the bbox frames where the batch has none."""
    clips = batch["clips"].to(device, dtype, non_blocking=True)
    if batch.get("bbox_images") is None:
        return clips, clips
    return clips, batch["bbox_images"].to(device, dtype, non_blocking=True)


def train_state_tree(state, ema=None) -> dict:
    """What a trainer checkpoints: its optimizer state (the f32 masters, the
    moments, the accumulated gradient and the counters) and its step, with
    the EMA where there is one. The module tensors are their masters
    rounded, so they are not saved."""
    tree = {"opt_state": state.opt_state, "step": state.step}
    if ema is not None:
        tree["ema"] = {"params": ema.params, "step": ema.step}
    return tree


def resume(ckpt, which: str, state, tx, ema=None) -> bool:
    """Restore ``checkpoint-{which}`` ("latest" or a step) into ``state``
    (and ``ema``) in place, bit for bit, and round the masters into the
    module tensors. False where there is no checkpoint."""
    restored = ckpt.restore(None if which == "latest" else int(which),
                            template=train_state_tree(state, ema))
    if restored is None:
        return False
    state.opt_state, state.step = restored["opt_state"], restored["step"]
    if ema is not None:
        ema.params, ema.step = restored["ema"]["params"], restored["ema"]["step"]
    tx.sync(state.opt_state, state.params)
    return True
