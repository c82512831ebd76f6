"""Train the AR bbox-predictor baseline (trajeglish style).

    python -m ctrlv_tpu_torch.tools.train_bbox_baseline key=value ...
    python -m ctrlv_tpu_torch.tools.train_bbox_baseline dataset=synthetic max_steps=40 device=cpu

Counterpart of ``tools/train_bbox_baseline.py``, with its loop: the model
initialised in f32 (seeded from ``cfg.seed``, or ``init_state`` where
given), global-norm clipping then AdamW under a linear warm-up to a constant
rate, the weight decay masked off the biases, norms and embeddings (optax's
``mask=`` masks the decay only, the update still applies), a loss line at
step 1 and every 20 steps, and a checkpoint of the parameters under
``output/baseline_checkpoints`` (the 7 latest kept) every 500 steps and at
the end. Runs on the card unless ``device=cpu``.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import torch
import torch.nn as nn

from ..baseline import BaselineConfig, BboxPredictorLM, process_data
from ..baseline.config import config_from_overrides
from ..data import get_dataloader
from ..models.layers import LayerNorm
from ..pipelines.common import resolve_device
from ..train.checkpoints import CheckpointManager
from ..train.state import AdamW, make_schedule

CHECKPOINT_DIR = os.path.join("output", "baseline_checkpoints")


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """QCNet-style AdamW split, the JAX tool's: no decay for biases, norms
    (flax's ``scale``, a LayerNorm's ``weight`` here) and embeddings
    (anything with "embed" in its path). Taken from the module types, since
    a norm's weight has the name of a Linear's."""
    mask = {}
    for mod_name, module in model.named_modules():
        for p_name, _ in module.named_parameters(recurse=False):
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            mask[name] = not (p_name == "bias" or isinstance(module, (LayerNorm, nn.Embedding))
                              or "embed" in name.lower())
    return mask


def make_tx(cfg: BaselineConfig, model: nn.Module) -> AdamW:
    """clip_by_global_norm, then adamw(linear warm-up -> constant, mask=decay_mask)."""
    schedule = make_schedule(cfg.lr, "constant", cfg.lr_warmup_steps)
    return AdamW(schedule, 0.9, 0.999, 1e-8, cfg.weight_decay, cfg.gradient_clip_val, None,
                 decay_mask=decay_mask(model))


def build_model(cfg: BaselineConfig, device, init_state=None) -> BboxPredictorLM:
    """The baseline in f32 on ``device``: seeded from ``cfg.seed``, or
    ``init_state`` (a state dict, loaded strictly)."""
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
        torch.manual_seed(cfg.seed)
        model = BboxPredictorLM(cfg).to(device)
    if init_state is not None:
        model.load_state_dict(init_state, strict=True)
    return model


def loss_fn(cfg: BaselineConfig, model: BboxPredictorLM, data) -> torch.Tensor:
    return BboxPredictorLM.loss(cfg, model(data))


def main(cfg: Optional[BaselineConfig] = None, max_steps=None, dataset_name=None,
         init_state=None, history: Optional[list] = None) -> BboxPredictorLM:
    """Train; returns the model. ``history``, where given, receives one
    ``{"step", "loss", "seconds"}`` a step (the loss as a float, the step's
    wall seconds with the card synchronised)."""
    cfg = cfg or BaselineConfig()
    dataset_name = dataset_name or cfg.dataset
    max_steps = max_steps or cfg.max_steps
    device = resolve_device(cfg.device)

    dataset, loader = get_dataloader(
        cfg.data_root, dataset_name, if_train=True,
        batch_size=cfg.train_batch_size, clip_length=cfg.num_timesteps,
        train_H=cfg.train_H, train_W=cfg.train_W, seed=cfg.seed,
    )
    frame_size = (dataset.orig_W, dataset.orig_H)
    # The JAX tool initialises from the loader's first batch, which takes the
    # shuffled loader's first epoch; drawn here too, training sees its batches.
    next(iter(loader))
    model = build_model(cfg, device, init_state)
    params = {k: p for k, p in model.named_parameters()}
    tx = make_tx(cfg, model)
    opt_state = tx.init(params)

    def step(data):
        loss = loss_fn(cfg, model, data)
        grads = torch.autograd.grad(loss, list(params.values()))
        tx.update(dict(zip(params, grads)), opt_state, params)
        return loss.detach()

    ckpt = CheckpointManager(CHECKPOINT_DIR, max_to_keep=7)
    global_step = 0
    t0 = time.time()
    while global_step < max_steps:
        for batch in loader:
            if global_step >= max_steps:
                break
            t_step = time.perf_counter()
            data = process_data(cfg, batch["objects"], frame_size, device)
            loss = step(data)
            global_step += 1
            if history is not None:
                value = float(loss)  # synchronises the card
                history.append(dict(step=global_step, loss=value,
                                    seconds=time.perf_counter() - t_step))
            if global_step % 20 == 0 or global_step == 1:
                print(f"step {global_step} loss {float(loss):.4f} "
                      f"({(time.time() - t0) / global_step:.2f}s/step)", flush=True)
            if global_step % 500 == 0:
                ckpt.save(global_step, model.state_dict())
    ckpt.save(global_step, model.state_dict(), wait=True)
    return model


if __name__ == "__main__":
    main(cfg=config_from_overrides())
