"""Train the spatio-temporal ControlNet (Box2Video, stage 2).

    python -m ctrlv_tpu_torch.tools.train_video_controlnet --dataset_name synthetic --device cpu ...

Counterpart of ``tools/train_video_controlnet.py``: the ControlNet starts as
a copy of the UNet, the UNet, VAE and CLIP stay frozen, and the EDM loss is
taken on the clip's latents with the bbox frames as the control (with
``--generate_bbox`` the other way round). AdamW (or Adafactor) under
``MultiSteps`` at ``--gradient_accumulation_steps`` above 1, under f32
master weights of the ControlNet; validation every ``--validation_steps``
micro-steps on ``--num_demo_samples`` cached samples, scalars every
micro-step, a training-state checkpoint every ``--checkpointing_steps`` and
one at the end (``--resume_from_checkpoint latest`` or a step resumes), then
the ControlNet's f32 weights exported under ``<output_dir>/pipeline``.

As in the JAX tool, the synthetic dataset means the tiny models, and a
resumed run draws its noise anew from ``--seed`` and starts the loader from
its first batch. ``main`` builds the models and the loader and hands them to
``train``. The tool runs on the card unless ``--device`` says otherwise.

Under ``torchrun --nproc_per_node N`` it trains data parallel over
``--mesh_data`` / ``--mesh_frame`` (``tools.common.train_mesh``): every rank
reads the same loader and keeps its rows of each global batch, and only rank
0 writes the tracker, the checkpoints and the export.
"""

from __future__ import annotations

import os
import time

import torch

from ..data import get_dataloader
from ..ops.attention import set_attention_impl
from ..pipelines import StableVideoControlPipeline
from ..train import (
    CheckpointManager,
    MasterWeights,
    MultiSteps,
    init_train_state,
    make_controlnet_train_step,
    make_optimizer,
    save_pipeline,
)
from ..train.observability import Tracker, collect_demo_samples, run_validation
from ..utils.config import Config, parse_args
from .common import (
    SilentTracker,
    batch_to_device,
    build_models,
    leads,
    resume,
    train_mesh,
    train_state_tree,
    whole,
)


def train(cfg: Config, models, loader):
    """The training loop over built models (``build_models(...,
    with_controlnet=True, masters=("ctrl",))``, whose f32 ControlNet becomes
    the masters and leaves ``models``) and a loader; returns the train
    state."""
    device, ctrl = models["device"], models["ctrl"]
    tx = make_optimizer(
        learning_rate=cfg.learning_rate,
        adam_weight_decay=cfg.adam_weight_decay,
        max_grad_norm=cfg.max_grad_norm,
        lr_scheduler=cfg.lr_scheduler,
        lr_warmup_steps=cfg.lr_warmup_steps,
        max_train_steps=cfg.max_train_steps,
        optimizer=cfg.optimizer,
        mu_dtype=cfg.adam_mu_dtype,
    )
    if cfg.gradient_accumulation_steps > 1:
        tx = MultiSteps(tx, cfg.gradient_accumulation_steps)
    tx = MasterWeights(tx, start=models["masters"].pop("ctrl"))
    state = init_train_state(ctrl.requires_grad_(True), tx)

    ckpt = CheckpointManager(os.path.join(cfg.output_dir, "checkpoints"),
                             max_to_keep=cfg.checkpoints_total_limit)
    if cfg.resume_from_checkpoint and resume(ckpt, cfg.resume_from_checkpoint, state, tx):
        print(f"resumed from step {state.step}")
    mesh, state = train_mesh(cfg, state)
    if not mesh.active:
        return None
    step_fn = make_controlnet_train_step(
        models["unet"], ctrl, models["vae"], models["clip"], tx,
        generate_bbox=cfg.generate_bbox,
        conditioning_dropout_prob=cfg.conditioning_dropout_prob,
        fps=cfg.fps,
        noise_aug_strength=cfg.noise_aug_strength,
        encode_chunk=cfg.vae_encode_chunk,
        device=device,
        mesh=mesh,
    )

    lead = leads()
    tracker = Tracker(cfg) if lead else SilentTracker()
    demo_samples = collect_demo_samples(loader, cfg.num_demo_samples)
    val_pipeline = StableVideoControlPipeline(models["unet"], ctrl, models["vae"], models["clip"],
                                              device=device)

    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    global_step = state.step
    max_steps = cfg.max_train_steps or (cfg.num_train_epochs * len(loader))
    t0 = time.time()
    while global_step < max_steps:
        for batch in loader:
            if global_step >= max_steps:
                break
            if (cfg.validation_steps and global_step > 0
                    and global_step % cfg.validation_steps == 0):
                run_validation(tracker, global_step, val_pipeline, demo_samples, cfg, generator,
                               controlnet=True)
                print(f"validation @ step {global_step}: media logged")
            clips, bbox = batch_to_device(batch, device)
            state, metrics = step_fn(state, clips, bbox, generator=generator)
            global_step += 1
            tracker.log_scalars(
                global_step, {"train_loss": metrics["loss"], "grad_norm": metrics["grad_norm"]})
            if lead and (global_step % 10 == 0 or global_step == 1):
                print(f"step {global_step} loss {float(metrics['loss']):.4f} "
                      f"({(time.time() - t0) / global_step:.2f}s/step)")
            if global_step % cfg.checkpointing_steps == 0:
                tree = train_state_tree(state)
                if lead:
                    ckpt.save(global_step, tree)
    tree = train_state_tree(state)
    masters = whole(state, state.opt_state["master"])
    if lead:
        ckpt.save(global_step, tree, wait=True)
    ckpt.close()
    tracker.finish()
    if lead:
        save_pipeline(os.path.join(cfg.output_dir, "pipeline"), controlnet=ctrl,
                      tensors={"controlnet": masters}, dtype=torch.float32)
    return state


def main(cfg=None):
    cfg = cfg or parse_args()
    set_attention_impl(cfg.attention_impl)
    tiny = cfg.dataset_name == "synthetic"
    models = build_models(cfg, tiny=tiny, with_controlnet=True, masters=("ctrl",))
    _, loader = get_dataloader(
        cfg.data_root, cfg.dataset_name, if_train=True, batch_size=cfg.train_batch_size,
        num_workers=cfg.dataloader_num_workers, clip_length=cfg.clip_length,
        if_return_bbox_im=True, train_H=cfg.train_H, train_W=cfg.train_W, seed=cfg.seed,
        pin_memory=models["device"].type == "cuda",
    )
    return train(cfg, models, loader)


if __name__ == "__main__":
    main()
