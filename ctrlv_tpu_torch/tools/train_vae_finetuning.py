"""Finetune the VAE decoder alone on the image MSE.

    python -m ctrlv_tpu_torch.tools.train_vae_finetuning --dataset_name synthetic --device cpu ...

Counterpart of ``tools/train_vae_finetuning.py``: the decoder's parameters
train (a partitioned subset, ``split_trainable(vae,
vae_decoder_predicate)``, under f32 master weights), the encoder is frozen,
the loss is the per-pixel MSE of the reconstructed frames. AdamW with the
JAX tool's arguments and no accumulation; reconstruction validation (PSNR)
every ``--validation_steps``; training-state checkpoints every
``--checkpointing_steps`` and at the end. As in the JAX tool, the run never
resumes (``--resume_from_checkpoint`` is not read) and writes no pipeline,
and the synthetic dataset means the tiny models. The tool runs on the card
unless ``--device`` says otherwise; under ``torchrun`` it trains data
parallel as the ControlNet trainer does (``tools.common.train_mesh``).
"""

from __future__ import annotations

import os
import time

import torch

from ..data import get_dataloader
from ..train import (
    CheckpointManager,
    MasterWeights,
    init_train_state,
    make_optimizer,
    make_vae_decoder_train_step,
    split_trainable,
    vae_decoder_predicate,
)
from ..train.observability import Tracker, collect_demo_samples, run_vae_validation
from ..utils.config import Config, parse_args
from .common import (
    SilentTracker,
    batch_to_device,
    build_models,
    leads,
    train_mesh,
    train_state_tree,
)


def train(cfg: Config, models, loader):
    """The training loop over built models (``build_models(...,
    masters=("vae",))``, whose f32 VAE it takes out of ``models``) and a
    loader; returns the train state."""
    device, vae = models["device"], models["vae"]
    tx = make_optimizer(
        learning_rate=cfg.learning_rate,
        max_grad_norm=cfg.max_grad_norm,
        lr_scheduler=cfg.lr_scheduler,
        lr_warmup_steps=cfg.lr_warmup_steps,
        max_train_steps=cfg.max_train_steps,
    )
    trainable = split_trainable(vae, vae_decoder_predicate)
    # the f32 values of the decoder; the f32 encoder is let go
    tx = MasterWeights(tx, start={k: v for k, v in models["masters"].pop("vae").items()
                                  if k in trainable})
    state = init_train_state(trainable, tx)
    mesh, state = train_mesh(cfg, state)
    if not mesh.active:
        return None
    step_fn = make_vae_decoder_train_step(vae, tx, device=device, mesh=mesh)

    ckpt = CheckpointManager(os.path.join(cfg.output_dir, "checkpoints"),
                             max_to_keep=cfg.checkpoints_total_limit)
    lead = leads()
    tracker = Tracker(cfg) if lead else SilentTracker()
    demo_samples = collect_demo_samples(loader, cfg.num_demo_samples)

    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    global_step = 0
    max_steps = cfg.max_train_steps or (cfg.num_train_epochs * len(loader))
    t0 = time.time()
    while global_step < max_steps:
        for batch in loader:
            if global_step >= max_steps:
                break
            if (cfg.validation_steps and global_step > 0
                    and global_step % cfg.validation_steps == 0):
                vm = run_vae_validation(tracker, global_step, vae, demo_samples, cfg)
                if lead:
                    print(f"validation @ step {global_step}: {vm}")
            clips, _ = batch_to_device(batch, device)
            state, metrics = step_fn(state, clips, generator=generator)
            global_step += 1
            tracker.log_scalars(global_step, {"train_loss": metrics["loss"]})
            if lead and (global_step % 10 == 0 or global_step == 1):
                print(f"step {global_step} loss {float(metrics['loss']):.5f} "
                      f"({(time.time() - t0) / global_step:.2f}s/step)")
            if global_step % cfg.checkpointing_steps == 0:
                tree = train_state_tree(state)
                if lead:
                    ckpt.save(global_step, tree)
    tree = train_state_tree(state)
    if lead:
        ckpt.save(global_step, tree, wait=True)
    ckpt.close()
    tracker.finish()
    return state


def main(cfg=None):
    cfg = cfg or parse_args()
    tiny = cfg.dataset_name == "synthetic"
    models = build_models(cfg, tiny=tiny, masters=("vae",))
    _, loader = get_dataloader(
        cfg.data_root, cfg.dataset_name, if_train=True, batch_size=cfg.train_batch_size,
        num_workers=cfg.dataloader_num_workers, clip_length=cfg.clip_length,
        if_return_bbox_im=False, train_H=cfg.train_H, train_W=cfg.train_W, seed=cfg.seed,
        pin_memory=models["device"].type == "cuda",
    )
    return train(cfg, models, loader)


if __name__ == "__main__":
    main()
