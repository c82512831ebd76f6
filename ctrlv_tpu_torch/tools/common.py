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
the device: ``device``, else ``cfg.device``, else the card (``cuda:LOCAL_RANK``
on a rank that ``torchrun`` started). Every rank builds the same seeded
weights.

On a mesh (``parallel/``) the trainers' ranks share what this module gives
them: ``train_mesh`` lays the train state on the data axis by the JAX tools'
rule, ``train_state_tree`` gathers ZeRO-1 slices (so a checkpoint is the one
rank's and resumes at any world size), and only rank 0 writes
(``leads``, ``SilentTracker``).
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
from ..parallel.mesh import idle_ranks, init_from_env, make_train_mesh, rank
from ..parallel.sharding import gathered_opt_state, shard_train_state
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
    device = device if device is not None else cfg.device
    init_from_env(device)  # a rank of torchrun joins its group on cuda:LOCAL_RANK
    device = resolve_device(device)
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
    rounded, so they are not saved. ZeRO-1 slices (of the EMA too) are
    gathered: every data rank must call it."""
    tree = {"opt_state": gathered_opt_state(state), "step": state.step}
    if ema is not None:
        tree["ema"] = {"params": whole(state, ema.params), "step": ema.step}
    return tree


def whole(state, tensors: dict) -> dict:
    """Tensors by parameter name, sliced like the state's ZeRO-1 plan or
    not, made whole (a collective where they are sliced)."""
    if state.shards is None:
        return tensors
    return {k: state.shards.gather(k, v) for k, v in tensors.items()}


def train_mesh(cfg: Config, state):
    """The trainers' mesh and the state laid on it, by the JAX tools' rule:
    a data axis that divides ``--train_batch_size`` (``make_train_mesh``),
    and ZeRO-1 under ``--optimizer_sharding zero1``, or ``auto`` with a data
    axis above one. Ranks outside the mesh are named; they sit the steps out
    (``mesh.active`` is False there)."""
    mesh = make_train_mesh(cfg.train_batch_size, n_data=cfg.mesh_data, n_frame=cfg.mesh_frame)
    idle = idle_ranks(mesh)
    if idle and leads():
        print(f"mesh {mesh.n_data}x{mesh.n_frame}: ranks {idle} sit the steps out")
    zero1 = cfg.optimizer_sharding == "zero1" or (
        cfg.optimizer_sharding == "auto" and mesh.n_data > 1)
    if mesh.active:
        state = shard_train_state(state, mesh, zero1=zero1)
    return mesh, state


def leads() -> bool:
    """Whether this process writes the tracker, checkpoints and exports:
    rank 0, or the lone process."""
    return rank() == 0


class SilentTracker:
    """The tracker of a rank other than 0: it logs nothing."""

    def log_scalars(self, step, scalars) -> None:
        pass

    def log_video(self, step, name, frames_uint8, fps) -> str:
        return ""

    def finish(self) -> None:
        pass


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
