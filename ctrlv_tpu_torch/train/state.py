"""Train state and the optimizer of the ControlNet regime.

Counterpart of ``ctrlv_tpu/train/state.py`` for what that regime runs:
global-norm clipping, AdamW with optax's update rule and an optional bf16
first moment, the constant, linear and cosine schedules, the non-finite
guard (``optax.apply_if_finite``) and gradient accumulation with
``optax.MultiSteps`` semantics. ``torch.optim.AdamW`` has no ``mu_dtype``
and another epsilon placement, hence the small optimizer here.

Parameters are updated in place; the state is a plain dictionary of
tensors and integers. A transformation has ``init(params) -> state`` and
``update(grads, state, params) -> state``, with ``params`` and ``grads``
dictionaries by parameter name.

Dtypes follow optax: the first moment is ``mu_dtype`` or the parameter's
dtype, the second moment and the accumulated gradient the parameter's. The
update itself is computed in f32 and rounded once into each of them, with
each decay constant rounded to the dtype of the array it multiplies, as JAX's
weak typing rounds it: that is optax's arithmetic under ``jit`` exactly for
f32 parameters with an f32 or bf16 first moment. For bf16 parameters it
keeps the reference's quirk that b2 = 0.999 is 1.0 beside a bf16 second
moment; f32 master weights, which come with the trainer CLI, remove it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    params: Params  # the trainable parameters by name, updated in place
    opt_state: dict
    step: int  # micro-steps taken


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    def schedule(count: int) -> float:
        if steps <= 0:
            return init
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def make_schedule(learning_rate: float, lr_scheduler: str = "constant",
                  lr_warmup_steps: int = 0,
                  max_train_steps: Optional[int] = None) -> Callable[[int], float]:
    """The learning rate at an update count, as the JAX package builds it
    from optax's schedules."""
    if lr_scheduler == "constant":
        if lr_warmup_steps > 0:
            return _linear(0.0, learning_rate, lr_warmup_steps)
        return lambda count: learning_rate
    total = max_train_steps or 100000
    warmup = _linear(0.0, learning_rate, lr_warmup_steps)
    if lr_scheduler == "linear":
        after = _linear(learning_rate, 0.0, total - lr_warmup_steps)
    elif lr_scheduler == "cosine":
        decay_steps = total - lr_warmup_steps
        if decay_steps <= 0:
            raise ValueError("cosine schedule: max_train_steps must exceed lr_warmup_steps")

        def after(count: int) -> float:
            return learning_rate * 0.5 * (1.0 + math.cos(math.pi * min(count, decay_steps)
                                                         / decay_steps))
    else:
        raise ValueError(lr_scheduler)
    return lambda count: warmup(count) if count < lr_warmup_steps else after(
        count - lr_warmup_steps)


def _as(value: float, dtype) -> float:
    """A Python constant as JAX's weak typing sees it beside an array of
    ``dtype``: rounded to that dtype. So a bf16 moment decays by bf16(0.9) =
    0.8984, and beside a bf16 second moment 0.999 is 1.0."""
    return float(torch.tensor(value, dtype=dtype))


def global_norm(grads: Params) -> torch.Tensor:
    """sqrt(sum of squares) over all gradients, an f32 scalar on their device."""
    norms = torch._foreach_norm(list(grads.values()), 2, dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(norms))


def _all_finite(grads: Params) -> bool:
    """No NaN and no Inf in any gradient: their largest magnitude is finite."""
    peaks = torch._foreach_norm(list(grads.values()), float("inf"))
    return bool(torch.isfinite(torch.stack([p.float() for p in peaks])).all())


class AdamW:
    """clip_by_global_norm, then optax's adamw: both moments, their bias
    corrections, m / (sqrt(v) + eps), the decoupled weight decay, and the
    step by the schedule at the count of updates so far."""

    def __init__(self, schedule, b1, b2, eps, weight_decay, max_grad_norm, mu_dtype):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps
        self.weight_decay, self.max_grad_norm, self.mu_dtype = weight_decay, max_grad_norm, mu_dtype

    def init(self, params: Params) -> dict:
        return {
            "count": 0,
            "mu": {k: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                   for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()},
        }

    @torch.no_grad()
    def update(self, grads: Params, state: dict, params: Params) -> dict:
        count = state["count"] + 1
        # optax computes 1 - decay**count in f32
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.int32(count))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.int32(count))
        lr = self.schedule(state["count"])
        g_norm = global_norm(grads)
        # below the limit a gradient passes as it is; a NaN norm clips, as in optax
        clip = not bool(g_norm < self.max_grad_norm)
        for name, p in params.items():
            g = grads[name].float()
            if clip:
                g = (g / g_norm) * self.max_grad_norm
            m, v = state["mu"][name], state["nu"][name]
            mu = _as(1 - self.b1, grads[name].dtype) * g + _as(self.b1, m.dtype) * m.float()
            nu = _as(1 - self.b2, grads[name].dtype) * g * g + _as(self.b2, v.dtype) * v.float()
            step = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps) + self.weight_decay * p.float()
            p.copy_(p.float() - lr * step)
            state["mu"][name].copy_(mu)
            state["nu"][name].copy_(nu)
        state["count"] = count
        return state


class ApplyIfFinite:
    """``optax.apply_if_finite``: an update whose gradients hold a NaN or an
    Inf is skipped, inner state and all, and counted; after more than
    ``max_consecutive_errors`` such updates in a row the next is let through."""

    def __init__(self, inner, max_consecutive_errors: int):
        self.inner, self.max_consecutive_errors = inner, max_consecutive_errors

    def init(self, params: Params) -> dict:
        return {"notfinite_count": 0, "last_finite": True, "total_notfinite": 0,
                "inner": self.inner.init(params)}

    def update(self, grads: Params, state: dict, params: Params) -> dict:
        finite = _all_finite(grads)
        state["notfinite_count"] = 0 if finite else state["notfinite_count"] + 1
        state["last_finite"] = finite
        state["total_notfinite"] += 0 if finite else 1
        if finite or state["notfinite_count"] > self.max_consecutive_errors:
            state["inner"] = self.inner.update(grads, state["inner"], params)
        return state


class MultiSteps:
    """``optax.MultiSteps``: the running mean of ``every_k_schedule``
    micro-gradients, and one update of the inner transformation on the k-th.
    Between updates the parameters do not move."""

    def __init__(self, inner, every_k_schedule: int):
        if every_k_schedule < 1:
            raise ValueError("every_k_schedule must be at least 1")
        self.inner, self.k = inner, int(every_k_schedule)

    def init(self, params: Params) -> dict:
        return {"mini_step": 0, "gradient_step": 0, "inner": self.inner.init(params),
                "acc_grads": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(self, grads: Params, state: dict, params: Params) -> dict:
        n = state["mini_step"]
        for name, acc in state["acc_grads"].items():
            if n == 0:
                acc.copy_(grads[name])
            else:
                acc.copy_(acc.float() + (grads[name].float() - acc.float()) / (n + 1))
        if n == self.k - 1:
            state["inner"] = self.inner.update(state["acc_grads"], state["inner"], params)
            state["gradient_step"] += 1
        state["mini_step"] = (n + 1) % self.k
        return state


def make_optimizer(
    learning_rate: float = 1e-5,
    adam_beta1: float = 0.9,
    adam_beta2: float = 0.999,
    adam_weight_decay: float = 1e-2,
    adam_epsilon: float = 1e-8,
    max_grad_norm: float = 1.0,
    lr_scheduler: str = "constant",
    lr_warmup_steps: int = 0,
    max_train_steps: Optional[int] = None,
    nan_guard_steps: int = 100,
    optimizer: str = "adamw",
    mu_dtype: Union[str, torch.dtype, None] = None,
):
    """The AdamW chain of the JAX package's ``make_optimizer``, with its
    keywords and defaults. ``nan_guard_steps`` > 0 wraps it in
    ``ApplyIfFinite``; wrap the result in ``MultiSteps`` to accumulate."""
    if optimizer != "adamw":
        raise ValueError(f"optimizer {optimizer!r}: only 'adamw' is ported")
    if isinstance(mu_dtype, str):
        mu_dtype = getattr(torch, mu_dtype)
    schedule = make_schedule(learning_rate, lr_scheduler, lr_warmup_steps, max_train_steps)
    tx = AdamW(schedule, adam_beta1, adam_beta2, adam_epsilon, adam_weight_decay, max_grad_norm,
               mu_dtype)
    if nan_guard_steps:
        tx = ApplyIfFinite(tx, nan_guard_steps)
    return tx


def init_train_state(params, tx) -> TrainState:
    """``params``: a module (its parameters that require a gradient) or a
    dictionary of tensors by name."""
    if isinstance(params, torch.nn.Module):
        params = {k: p for k, p in params.named_parameters() if p.requires_grad}
    params = dict(params)
    return TrainState(params=params, opt_state=tx.init(params), step=0)
