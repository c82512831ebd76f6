"""What the port's multi-rank tests run on each rank.

``ctrlv_tpu_torch.parallel.launch.spawn`` starts these functions in fresh
processes (``spawn``, ``gloo``, a ``file://`` rendezvous), which import them
from here by name; this module imports the port only, so that a rank never
loads JAX. Each case also runs alone, in the test's own process without a
process group, as the one-rank reference. A rank writes what it computed to
``out/rank{r}.pt``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ctrlv_tpu_torch.models import (
    AutoencoderKLTemporalDecoder,
    CLIPVisionConfig,
    CLIPVisionModelWithProjection,
    ControlNetSpatioTemporal,
    UNetSpatioTemporalConditionModel,
    UNetSTConfig,
    VAEConfig,
    controlnet_from_unet,
)
from ctrlv_tpu_torch.parallel import (
    gathered_opt_state,
    make_mesh,
    make_train_mesh,
    shard_train_state,
)
from ctrlv_tpu_torch.parallel.sharding import SHARDED_STATE
from ctrlv_tpu_torch.train import (
    MasterWeights,
    MultiSteps,
    init_train_state,
    make_controlnet_train_step,
    make_optimizer,
    make_svd_train_step,
    split_trainable,
    temporal_blocks_predicate,
)

B, F, H, W = 4, 3, 16, 16
STEPS, ACCUM = 4, 2  # two updates of two micro-steps each
ZERO1_MIN_SIZE = 2**10  # low enough that the micro models have sliced tensors


def save(out: str, rank: int, result) -> None:
    os.makedirs(out, exist_ok=True)
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))


def micro_models() -> dict:
    """The micro UNet and its ControlNet, the tiny VAE and a one-layer CLIP,
    f32 and seeded: the same weights on every rank."""
    torch.manual_seed(0)
    ucfg = UNetSTConfig.micro()
    unet = UNetSpatioTemporalConditionModel(ucfg)
    ctrl = ControlNetSpatioTemporal(ucfg)
    controlnet_from_unet(unet, ctrl)
    vae = AutoencoderKLTemporalDecoder(VAEConfig.tiny())
    clip = CLIPVisionModelWithProjection(
        dataclasses.replace(CLIPVisionConfig.tiny(), num_hidden_layers=1))
    return dict(unet=unet, ctrl=ctrl, vae=vae, clip=clip)


def global_batch():
    rng = np.random.default_rng(3)
    clips = rng.uniform(-1, 1, (B, F, H, W, 3)).astype(np.float32)
    bbox = rng.uniform(-1, 1, (B, F, H, W, 3)).astype(np.float32)
    return torch.from_numpy(clips), torch.from_numpy(bbox)


def sharded_shapes(tree, path="") -> dict:
    """{path: shape} of the optimizer-state tensors that ZeRO-1 may slice."""
    out = {}
    for key, value in tree.items():
        if key in SHARDED_STATE and isinstance(value, dict):
            out.update({f"{path}/{key}/{k}": tuple(t.shape) for k, t in value.items()})
        elif isinstance(value, dict):
            out.update(sharded_shapes(value, f"{path}/{key}"))
    return out


def train_case(rank: int, world: int, out: str, kind: str, zero1: bool,
               optimizer: str = "adamw") -> None:
    """``STEPS`` data-parallel micro-steps of the ControlNet step
    (``kind="controlnet"``) or of the stage-1 step on the temporal blocks
    (``"svd_temporal"``) on the global batch, under f32 master weights and
    accumulation ``ACCUM``; the logged losses and norms, the parameters
    after, the whole optimizer state and this rank's slices' shapes."""
    m = micro_models()
    # a clip norm below the gradients' (0.03-0.2): the clip, and so the global
    # norm over the slices of a ZeRO-1 update, decides every update
    tx = MasterWeights(MultiSteps(make_optimizer(learning_rate=1e-5, optimizer=optimizer,
                                                 max_grad_norm=0.01), ACCUM))
    if kind == "controlnet":
        params = m["ctrl"].requires_grad_(True)
        step = make_controlnet_train_step(m["unet"], m["ctrl"], m["vae"], m["clip"], tx,
                                          conditioning_dropout_prob=0.3, device="cpu",
                                          mesh=make_train_mesh(B))
    else:
        params = split_trainable(m["unet"], temporal_blocks_predicate)
        step = make_svd_train_step(m["unet"], m["vae"], m["clip"], tx, partitioned=True,
                                   conditioning_dropout_prob=0.3, device="cpu",
                                   mesh=make_train_mesh(B))
    state = init_train_state(params, tx)
    state = shard_train_state(state, make_train_mesh(B), zero1=zero1,
                              min_size=ZERO1_MIN_SIZE)
    clips, bbox = global_batch()
    gen = torch.Generator().manual_seed(0)
    losses, norms = [], []
    for _ in range(STEPS):
        state, metrics = step(state, clips, bbox, generator=gen)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    save(out, rank, dict(
        losses=losses, norms=norms,
        params={k: p.detach().clone() for k, p in state.params.items()},
        opt_state=gathered_opt_state(state),
        local_shapes=sharded_shapes(state.opt_state),
        sliced=sorted(state.shards.axes) if state.shards is not None else [],
    ))


def pipeline_case(rank: int, world: int, inp: str, out: str, n_data: int,
                  n_frame: int) -> None:
    """The tiny Box2Video sampler (``inp/box2video.pt``: state dicts, inputs,
    injected noises, sampling keywords) on an (n_data, n_frame) mesh."""
    from ctrlv_tpu_torch.pipelines import StableVideoControlPipeline

    spec = torch.load(os.path.join(inp, "box2video.pt"))
    ucfg = UNetSTConfig.tiny()
    models = [UNetSpatioTemporalConditionModel(ucfg), ControlNetSpatioTemporal(ucfg),
              AutoencoderKLTemporalDecoder(VAEConfig.tiny()),
              CLIPVisionModelWithProjection(CLIPVisionConfig.tiny())]
    for module, sd in zip(models, spec["state_dicts"]):
        module.load_state_dict(sd, strict=True)
    mesh = make_mesh(n_data, n_frame) if world > 1 else None
    pipe = StableVideoControlPipeline(*[m.eval() for m in models], device="cpu", mesh=mesh)
    frames = pipe(spec["image"], spec["cond"], image_noise=spec["image_noise"],
                  latents=spec["latents"], **spec["kwargs"])
    save(out, rank, frames)


def overall_case(rank: int, world: int, out: str, n_data: int, n_frame: int) -> None:
    """The tiny overall pipeline on one synthetic-like sample, on an
    (n_data, n_frame) mesh: the chosen candidate, its scores and the video."""
    from ctrlv_tpu_torch.pipelines import (
        OverallPipeline,
        StableVideoControlPipeline,
        VideoDiffusionPipeline,
    )

    torch.manual_seed(1)
    ucfg = UNetSTConfig.tiny()
    unet = UNetSpatioTemporalConditionModel(ucfg)
    ctrl = ControlNetSpatioTemporal(ucfg)
    controlnet_from_unet(unet, ctrl)
    vae = AutoencoderKLTemporalDecoder(VAEConfig.tiny())
    clip = CLIPVisionModelWithProjection(CLIPVisionConfig.tiny())
    mesh = make_mesh(n_data, n_frame) if world > 1 else None
    pipe = OverallPipeline(
        VideoDiffusionPipeline(unet, vae, clip, device="cpu", mesh=mesh),
        StableVideoControlPipeline(unet, ctrl, vae, clip, device="cpu", mesh=mesh))
    rng = np.random.default_rng(5)
    image = torch.from_numpy(rng.uniform(-1, 1, (H, W, 3)).astype(np.float32))
    bbox = torch.from_numpy(rng.uniform(-1, 1, (F, H, W, 3)).astype(np.float32))
    result = pipe(image, bbox, torch.Generator().manual_seed(2), num_frames=F,
                  stage1_steps=2, stage2_steps=2, decode_chunk_size=2)
    save(out, rank, result)


def tool_case(rank: int, world: int, tool: str, argv: list) -> None:
    """A command's ``main`` on this rank, with its own arguments."""
    import importlib

    from ctrlv_tpu_torch.utils.config import parse_args

    module = importlib.import_module(f"ctrlv_tpu_torch.tools.{tool}")
    result = module.main(parse_args(argv))
    out = argv[argv.index("--output_dir") + 1]
    if tool == "eval_overall":
        save(os.path.join(out, "ranks"), rank, result)
