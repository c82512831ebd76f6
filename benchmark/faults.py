"""Faults planted in the program's timed path, to show that the comparison
which decides ``correct`` catches each.

    python -m benchmark.run ... --fault <name>

A fault replaces a function or method of the program for the rest of the
process (``plant``); the tests plant the same ones through pytest's
``monkeypatch``. The benchmark's own runs plant none. Each fault names the
cell kinds (``kind`` of a traffic file) it applies to.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, Tuple

import torch

SAMPLING = ("box2video", "bbox_predict")
TRAINING = ("controlnet_train",)
FAULTS: Dict[str, Tuple[tuple, Callable]] = {}


def fault(*kinds):
    def register(fn):
        FAULTS[fn.__name__] = (kinds, fn)
        return fn
    return register


def pipeline_module(kind: str):
    name = "video_control" if kind == "box2video" else "video_diffusion"
    return importlib.import_module(f"ctrlv_tpu_torch.pipelines.{name}")


def plant(name: str, kind: str, patch=setattr) -> None:
    """Plant fault ``name`` in the program for a cell of ``kind``; ``patch``
    is called as ``setattr`` is."""
    if name not in FAULTS:
        raise ValueError(f"no fault {name!r}; the faults are {sorted(FAULTS)}")
    kinds, fn = FAULTS[name]
    if kind not in kinds:
        raise ValueError(f"fault {name!r} does not apply to a {kind} cell")
    fn(patch, kind)


# ---- sampling (and their training counterparts) ----

@fault(*SAMPLING, *TRAINING)
def unchanged_state(patch, kind):
    """Serving: the Euler step returns its state. Training: the step computes
    its gradients and leaves the optimizer's state as it was."""
    if kind in TRAINING:
        import ctrlv_tpu_torch.train.train_step as ts

        patch(ts, "_data_parallel_update",
              lambda tx, state, grads, loss, mesh: (loss, ts.global_norm(grads)))
        return
    patch(pipeline_module(kind), "euler_step", lambda pred, latents, s, s_next: latents)


@fault(*SAMPLING)
def half_batch(patch, kind):
    """The UNet computes the first half of its batch and gives it for both."""
    from ctrlv_tpu_torch.models.unet_st import UNetSpatioTemporalConditionModel

    real = UNetSpatioTemporalConditionModel.forward

    def forward(self, sample, *args, **kwargs):
        out = real(self, sample, *args, **kwargs)
        half = out.shape[0] // 2
        return torch.cat([out[:half], out[:half]]) if half else out

    patch(UNetSpatioTemporalConditionModel, "forward", forward)


@fault(*SAMPLING, *TRAINING)
def altered_answer(patch, kind):
    """Serving: the frames altered where they are made. Training: the loss
    scaled by 1.5 where it is made."""
    if kind in TRAINING:
        import ctrlv_tpu_torch.train.train_step as ts

        real = ts.edm_denoising_loss
        patch(ts, "edm_denoising_loss", lambda *a: real(*a) * 1.5)
        return
    patch(pipeline_module(kind), "postprocess_frames",
          lambda frames: torch.clamp(frames / 2.0 + 0.6, 0.0, 1.0))


@fault("bbox_predict")
def altered_choice(patch, kind):
    """Stage 1 hands on another candidate than the one the IoU chose."""
    from .cells import bbox_predict

    real = bbox_predict.Cell.request

    def request(self, index):
        out = real(self, index)
        out["best"] = (out["best"] + 1) % self.n
        return out

    patch(bbox_predict.Cell, "request", request)


@fault(*SAMPLING)
def uncond_as_cond(patch, kind):
    """The unconditional half of the guidance batch gets the conditional
    inputs (CLIP rows and latents), so guidance has no effect."""
    from ctrlv_tpu_torch.pipelines import common

    patch(common, "_with_negative", lambda x, do_cfg: torch.cat([x, x]) if do_cfg else x)


@fault(*SAMPLING)
def wrong_time_ids(patch, kind):
    """The micro-conditioning's motion bucket is left at 0."""
    module = pipeline_module(kind)
    real = module.get_add_time_ids

    def get_add_time_ids(cfg, batch, do_cfg, device=None):
        ids = real(cfg, batch, do_cfg, device).clone()
        ids[:, 1] = 0.0
        return ids

    patch(module, "get_add_time_ids", get_add_time_ids)


@fault(*SAMPLING)
def no_last_step(patch, kind):
    """The last Euler step, to sigma 0, is skipped."""
    module = pipeline_module(kind)
    real = module.euler_step

    def euler_step(pred, latents, sigma, sigma_next):
        return latents if float(sigma_next) == 0.0 else real(pred, latents, sigma, sigma_next)

    patch(module, "euler_step", euler_step)


# ---- training ----

def _multi_steps_update(count_of):
    """``MultiSteps.update`` with the running mean's count taken by
    ``count_of(state)``; the rest as the program has it."""
    def update(self, grads, state, params):
        with torch.no_grad():
            n = count_of(self, state)
            for name, acc in state["acc_grads"].items():
                if n == 0:
                    acc.copy_(grads[name])
                else:
                    acc.copy_(acc.float() + (grads[name].float() - acc.float()) / (n + 1))
            if state["mini_step"] == self.k - 1:
                state["inner"] = self.inner.update(state["acc_grads"], state["inner"], params)
                state["gradient_step"] += 1
            state["mini_step"] = (state["mini_step"] + 1) % self.k
        return state
    return update


@fault(*TRAINING)
def last_only(patch, kind):
    """Each update applies its last micro-step's gradient alone: the rest of
    the accumulated batch is left out."""
    from ctrlv_tpu_torch.train.state import MultiSteps

    patch(MultiSteps, "update", _multi_steps_update(lambda self, state: 0))


@fault(*TRAINING)
def no_reset(patch, kind):
    """The accumulator is never reset: each update applies the mean of every
    micro-step since the start."""
    from ctrlv_tpu_torch.train.state import MultiSteps

    patch(MultiSteps, "update", _multi_steps_update(
        lambda self, state: state["gradient_step"] * self.k + state["mini_step"]))
