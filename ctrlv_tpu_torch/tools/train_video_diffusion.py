"""Train the SVD UNet: the stage-1 bbox predictor or a full, temporal-only or
LoRA finetune.

    python -m ctrlv_tpu_torch.tools.train_video_diffusion --dataset_name synthetic --predict_bbox --device cpu ...

Counterpart of ``tools/train_video_diffusion.py``. The regime follows the
JAX tool (the reference's ``--backprop_temporal_blocks_start_iter``):

- ``start_iter == 0``: the temporal transformer blocks alone train, as a
  partitioned subset (gradients and moments exist for it only);
- ``start_iter > 0``: every parameter trains until update ``start_iter``,
  the temporal blocks alone from it on (``scheduled_freeze``);
- ``start_iter < 0``: the full finetune;
- ``--enable_lora``: rank-``--rank`` f32 adapters beside the frozen UNet,
  which skips the regime.

AdamW (or Adafactor) with ``--scale_lr``, ``MultiSteps`` at accumulation
above 1, f32 master weights of what trains; ``--use_ema`` keeps an f32 EMA
of the masters, updated every micro-step. Validation every
``--validation_steps`` micro-steps runs on the EMA weights or the LoRA
weights where those are on; checkpoints and resume as in the ControlNet
trainer; at the end the pipeline (UNet, VAE, CLIP) in f32 under
``<output_dir>/pipeline``, with LoRA merged, and the EMA UNet under
``pipeline_ema``. ``--split_train_step`` has no counterpart: the port runs
its one step and says so. ``--use_ema`` with ``--enable_lora`` raises: the
JAX tool averages the UNet's parameters, which LoRA leaves frozen, and fails
on that pair too.

As in the JAX tool, the synthetic dataset means the tiny models, and a
resumed run draws its noise anew from ``--seed`` and starts the loader from
its first batch. The tool runs on the card unless ``--device`` says
otherwise.

Under ``torchrun --nproc_per_node N`` it trains data parallel over
``--mesh_data`` / ``--mesh_frame`` (``tools.common.train_mesh``), as the
ControlNet trainer does; under ZeRO-1 the EMA is sliced as the masters are.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from ..data import get_dataloader
from ..ops.attention import set_attention_impl
from ..pipelines import VideoDiffusionPipeline
from ..train import (
    CheckpointManager,
    MasterWeights,
    MultiSteps,
    ema_init,
    ema_update,
    init_train_state,
    lora_applied,
    lora_init,
    make_optimizer,
    make_svd_train_step,
    merge_lora,
    save_pipeline,
    split_trainable,
    temporal_blocks_predicate,
    trainable_mask,
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


@contextlib.contextmanager
def swapped_in(params, values):
    """Inside this block each tensor of ``params`` holds its entry of
    ``values`` (rounded to its dtype); after it, its own value again."""
    names = list(values)
    saved = [params[k].detach().clone() for k in names]
    with torch.no_grad():
        torch._foreach_copy_([params[k] for k in names], [values[k] for k in names])
    try:
        yield
    finally:
        with torch.no_grad():
            torch._foreach_copy_([params[k] for k in names], saved)


def train(cfg: Config, models, loader):
    """The training loop over built models (``build_models(...,
    masters=("unet",))``, whose f32 UNet it takes out of ``models``; LoRA
    needs no masters) and a loader; returns the train state."""
    if cfg.use_ema and cfg.enable_lora:
        raise ValueError("--use_ema with --enable_lora: the EMA averages the UNet's parameters, "
                         "which LoRA leaves frozen")
    if cfg.split_train_step:
        print("--split_train_step has no counterpart in the port: one step runs")
    device, unet = models["device"], models["unet"]
    start_iter = cfg.backprop_temporal_blocks_start_iter
    partitioned = not cfg.enable_lora and start_iter == 0
    sched_mask = (trainable_mask(unet, temporal_blocks_predicate)
                  if not cfg.enable_lora and start_iter > 0 else None)
    tx = make_optimizer(
        learning_rate=cfg.learning_rate * (
            cfg.train_batch_size * cfg.gradient_accumulation_steps if cfg.scale_lr else 1),
        adam_beta1=cfg.adam_beta1,
        adam_beta2=cfg.adam_beta2,
        adam_weight_decay=cfg.adam_weight_decay,
        adam_epsilon=cfg.adam_epsilon,
        max_grad_norm=cfg.max_grad_norm,
        lr_scheduler=cfg.lr_scheduler,
        lr_warmup_steps=cfg.lr_warmup_steps,
        max_train_steps=cfg.max_train_steps,
        scheduled_mask=sched_mask,
        freeze_start_iter=start_iter,
        optimizer=cfg.optimizer,
        mu_dtype=cfg.adam_mu_dtype,
    )
    if cfg.gradient_accumulation_steps > 1:
        tx = MultiSteps(tx, cfg.gradient_accumulation_steps)

    if cfg.enable_lora:
        unet.requires_grad_(False)
        trainable = lora_init(torch.Generator(device=device).manual_seed(cfg.seed), unet, cfg.rank)
        tx = MasterWeights(tx)  # the adapters are f32: their own masters
    else:
        trainable = split_trainable(unet, temporal_blocks_predicate if partitioned
                                    else lambda name: True)
        # the f32 values of what trains; the rest of the f32 UNet is let go
        tx = MasterWeights(tx, start={k: v for k, v in models["masters"].pop("unet").items()
                                      if k in trainable})
    state = init_train_state(trainable, tx)
    ema = ema_init(state.opt_state["master"]) if cfg.use_ema else None

    ckpt = CheckpointManager(os.path.join(cfg.output_dir, "checkpoints"),
                             max_to_keep=cfg.checkpoints_total_limit)
    if cfg.resume_from_checkpoint and resume(ckpt, cfg.resume_from_checkpoint, state, tx, ema):
        print(f"resumed from step {state.step}")
    mesh, state = train_mesh(cfg, state)
    if not mesh.active:
        return None
    if ema is not None and state.shards is not None:
        ema.params = {k: state.shards.local(k, v).clone() for k, v in ema.params.items()}
    masters = state.opt_state["master"]
    step_fn = make_svd_train_step(
        unet, models["vae"], models["clip"], tx,
        predict_bbox=cfg.predict_bbox,
        num_cond_bbox_frames=cfg.num_cond_bbox_frames,
        conditioning_dropout_prob=cfg.conditioning_dropout_prob,
        fps=cfg.fps,
        noise_aug_strength=cfg.noise_aug_strength,
        lora=cfg.enable_lora,
        partitioned=partitioned,
        encode_chunk=cfg.vae_encode_chunk,
        device=device,
        mesh=mesh,
    )

    lead = leads()
    tracker = Tracker(cfg) if lead else SilentTracker()
    demo_samples = collect_demo_samples(loader, cfg.num_demo_samples)
    val_pipeline = VideoDiffusionPipeline(unet, models["vae"], models["clip"], device=device)

    def validation_weights():
        """The EMA weights where it is on, the adapters applied for LoRA."""
        if ema is not None:
            return swapped_in(state.params, whole(state, ema.params))
        if cfg.enable_lora:
            return lora_applied(unet, state.params)
        return contextlib.nullcontext()

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
                with torch.no_grad(), validation_weights():
                    vm = run_validation(tracker, global_step, val_pipeline, demo_samples, cfg,
                                        generator, predict_bbox=cfg.predict_bbox)
                if lead:
                    print(f"validation @ step {global_step}: {vm or 'media logged'}")
            clips, bbox = batch_to_device(batch, device)
            state, metrics = step_fn(state, clips, bbox, generator=generator)
            global_step += 1
            if ema is not None:
                ema_update(ema, masters)
            tracker.log_scalars(
                global_step, {"train_loss": metrics["loss"], "grad_norm": metrics["grad_norm"]})
            if lead and (global_step % 10 == 0 or global_step == 1):
                print(f"step {global_step} loss {float(metrics['loss']):.4f} "
                      f"({(time.time() - t0) / global_step:.2f}s/step)")
            if global_step % cfg.checkpointing_steps == 0:
                tree = train_state_tree(state, ema)
                if lead:
                    ckpt.save(global_step, tree)
    tree = train_state_tree(state, ema)
    if lead:
        ckpt.save(global_step, tree, wait=True)
    ckpt.close()
    tracker.finish()

    if cfg.enable_lora:
        unet_tensors = merge_lora({k: v.float() for k, v in unet.state_dict().items()},
                                  state.params)
    else:
        unet_tensors = whole(state, masters)
    ema_tensors = None if ema is None else whole(state, ema.params)
    if lead:
        save_pipeline(os.path.join(cfg.output_dir, "pipeline"), unet=unet, vae=models["vae"],
                      image_encoder=models["clip"], tensors={"unet": unet_tensors},
                      dtype=torch.float32)
        if ema is not None:
            save_pipeline(os.path.join(cfg.output_dir, "pipeline_ema"), unet=unet,
                          tensors={"unet": ema_tensors}, dtype=torch.float32)
        print(f"done at step {global_step}")
    return state


def main(cfg=None):
    cfg = cfg or parse_args()
    set_attention_impl(cfg.attention_impl)
    tiny = cfg.dataset_name == "synthetic"
    models = build_models(cfg, tiny=tiny, masters=() if cfg.enable_lora else ("unet",))
    _, loader = get_dataloader(
        cfg.data_root, cfg.dataset_name, if_train=True, batch_size=cfg.train_batch_size,
        num_workers=cfg.dataloader_num_workers, clip_length=cfg.clip_length,
        if_return_bbox_im=cfg.predict_bbox, train_H=cfg.train_H, train_W=cfg.train_W,
        seed=cfg.seed, pin_memory=models["device"].type == "cuda",
    )
    return train(cfg, models, loader)


if __name__ == "__main__":
    main()
