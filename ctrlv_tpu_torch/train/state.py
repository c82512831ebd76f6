"""Train state, the trainable subsets of the three regimes and their
optimizers.

Counterpart of ``ctrlv_tpu/train/state.py``: the predicates and helpers that
pick a regime's trainable parameters (``trainable_mask``, ``split_trainable``
and ``merge_trainable`` with ``temporal_blocks_predicate`` and
``vae_decoder_predicate``), global-norm clipping, AdamW with optax's update
rule and an optional bf16 first moment, Adafactor with the arguments the JAX
factory gives optax, the constant, linear and cosine schedules, the masked
optimizer (``optax.multi_transform`` with ``set_to_zero``), the full-then-
masked ``scheduled_freeze``, the non-finite guard (``optax.apply_if_finite``)
and gradient accumulation with ``optax.MultiSteps`` semantics.
``torch.optim.AdamW`` has no ``mu_dtype`` and another epsilon placement,
hence the small optimizers here.

Where the JAX package has pytrees and path tuples, the port has
dictionaries by parameter name (``named_parameters()``) and predicates on
that dotted name. Parameters are updated in place; the state is a plain
dictionary of tensors and integers. A transformation has ``init(params) ->
state`` and ``update(grads, state, params) -> state``, with ``params`` and
``grads`` dictionaries by parameter name.

Dtypes follow optax: the first moment is ``mu_dtype`` or the parameter's
dtype, the second moment and the accumulated gradient the parameter's. The
update itself is computed in f32 and rounded once into each of them, with
each decay constant rounded to the dtype of the array it multiplies, as JAX's
weak typing rounds it: that is optax's arithmetic under ``jit`` exactly for
f32 parameters with an f32 or bf16 first moment.

The JAX trainers hold f32 parameters and compute in bf16 (each layer casts
its weights as it computes). ``MasterWeights`` gives the port the same: the
modules hold bf16 tensors, the optimizer sees an f32 master of each, and the
update writes every master back into its module tensor rounded to nearest
even, as ``astype(bf16)`` rounds in the JAX layer. The gradient with respect
to an f32 parameter that a layer casts to bf16 is the bf16 gradient upcast,
so the update equals optax's on the f32 parameters given the same
gradients. Without it, bf16 parameters keep the reference's quirk that b2 =
0.999 is 1.0 beside a bf16 second moment, and at a learning rate of 1e-5
most updates round away.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    params: Params  # the trainable parameters by name, updated in place
    opt_state: dict
    step: int  # micro-steps taken
    # the ZeRO-1 plan (``parallel.sharding.Zero1``) where ``shard_train_state``
    # sliced the optimizer state over a data axis; None where it is whole
    shards: Any = None


# The ZeRO-1 plan of the update that is running, or None. While it is set the
# optimizers see each sliced parameter, gradient and moment as this rank's
# slice: elementwise arithmetic needs nothing more, and what is taken over
# whole tensors (the global norm, the finite test, Adafactor's statistics)
# reads the other data ranks through it.
_SHARDS = None


@contextlib.contextmanager
def sharded_update(shards):
    """Run an optimizer update on the slices of a ZeRO-1 plan."""
    global _SHARDS
    prev, _SHARDS = _SHARDS, shards
    try:
        yield
    finally:
        _SHARDS = prev


def named_tensors(params) -> Params:
    """A module's parameters by name, or a copy of the dictionary given."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def trainable_mask(params, predicate: Callable[[str], bool]) -> Dict[str, bool]:
    """Which parameters receive updates, by name."""
    return {name: bool(predicate(name)) for name in named_tensors(params)}


def temporal_blocks_predicate(name: str) -> bool:
    """The temporal-only finetune: any parameter of a temporal transformer block."""
    return "temporal_transformer_blocks" in name


def vae_decoder_predicate(name: str) -> bool:
    return name.split(".", 1)[0] == "decoder"


def split_trainable(params, predicate: Callable[[str], bool]) -> Params:
    """The trainable subset by name: the very tensors, not copies. Given a
    module, its parameters are also asked for a gradient exactly where the
    predicate holds, so that gradients and optimizer moments exist for the
    subset only."""
    if isinstance(params, torch.nn.Module):
        for name, p in params.named_parameters():
            p.requires_grad_(bool(predicate(name)))
    return {name: p for name, p in named_tensors(params).items() if predicate(name)}


def merge_trainable(full: Params, subset: Params) -> Params:
    """The full dictionary with the trainable subset laid over it."""
    merged = dict(full)
    merged.update(subset)
    return merged


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
    """sqrt(sum of squares) over all gradients, an f32 scalar on their device.
    Inside ``sharded_update`` the sliced gradients' squares are summed over
    the data ranks first."""
    norms = torch._foreach_norm(list(grads.values()), 2, dtype=torch.float32)
    if _SHARDS is None:
        return torch.linalg.vector_norm(torch.stack(norms))
    squares = torch.stack(norms) ** 2
    sliced = torch.tensor([k in _SHARDS for k in grads], device=squares.device)
    total = _SHARDS.sum(squares[sliced].sum()) + squares[~sliced].sum()
    return torch.sqrt(total)


def _all_finite(grads: Params) -> bool:
    """No NaN and no Inf in any gradient: their largest magnitude is finite.
    Inside ``sharded_update`` every data rank takes the same decision."""
    peaks = torch._foreach_norm(list(grads.values()), float("inf"))
    bad = (~torch.isfinite(torch.stack([p.float() for p in peaks]))).sum().float()
    if _SHARDS is not None:
        bad = _SHARDS.sum(bad)
    return not bool(bad)


class AdamW:
    """clip_by_global_norm, then optax's adamw: both moments, their bias
    corrections, m / (sqrt(v) + eps), the decoupled weight decay, and the
    step by the schedule at the count of updates so far. ``decay_mask`` is
    optax's ``mask=``: a parameter it marks false is updated without the
    weight decay (not frozen)."""

    def __init__(self, schedule, b1, b2, eps, weight_decay, max_grad_norm, mu_dtype,
                 decay_mask: Optional[Dict[str, bool]] = None):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps
        self.weight_decay, self.max_grad_norm, self.mu_dtype = weight_decay, max_grad_norm, mu_dtype
        self.decay_mask = decay_mask

    def init(self, params: Params) -> dict:
        return {
            "count": 0,
            "mu": {k: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                   for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()},
        }

    @torch.no_grad()
    def update(self, grads: Params, state: dict, params: Params, hold=frozenset()) -> dict:
        """``hold``: names whose moments take the gradient while the parameter
        itself stays where it is (``scheduled_freeze`` after its switch)."""
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
            if name not in hold:
                step = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
                if self.decay_mask is None or self.decay_mask[name]:
                    step = step + self.weight_decay * p.float()
                p.copy_(p.float() - lr * step)
            state["mu"][name].copy_(mu)
            state["nu"][name].copy_(nu)
        state["count"] = count
        return state


def _factored_dims(shape, min_dim_size_to_factor: int):
    """The second-largest and the largest axis, where both reach the
    threshold; else None (optax's rule, ties broken as numpy's argsort does)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor:
    """clip_by_global_norm, then ``optax.adafactor`` as the JAX factory calls
    it: factored second moments for leaves with two axes of 128 or more, the
    decay 1 - (t + 1)^-0.8, per-leaf RMS clipping at 1.0, no parameter-scale
    multiplication, no momentum, the learning rate, then the weight decay
    (added after the learning rate, so it is not scaled by it). ``eps`` is
    the factory's ``adam_epsilon``, which takes the place of Adafactor's own
    1e-30 beside the squared gradient: the reference's quirk, kept.

    A factored leaf keeps ``v_row`` (its shape without the largest axis) and
    ``v_col`` (without the second largest) in place of a full ``v``.

    Under ZeRO-1 its state stays whole on every rank: the statistics and the
    RMS clip are taken over whole tensors, so a sliced gradient is gathered
    first and the update computed from the full gradient; only the slice of
    the master that this rank holds is written."""

    def __init__(self, schedule, eps, weight_decay, max_grad_norm, decay_rate: float = 0.8,
                 min_dim_size_to_factor: int = 128, clipping_threshold: float = 1.0):
        self.schedule, self.eps, self.weight_decay = schedule, eps, weight_decay
        self.max_grad_norm, self.decay_rate = max_grad_norm, decay_rate
        self.min_dim, self.clipping_threshold = min_dim_size_to_factor, clipping_threshold

    def init(self, params: Params) -> dict:
        state = {"count": 0, "v_row": {}, "v_col": {}, "v": {}}
        for name, p in params.items():
            # whole under ZeRO-1 too (a reset inside ``sharded_update`` sees slices)
            shape = tuple(p.shape) if _SHARDS is None else _SHARDS.full_shape(name, p)
            dims = _factored_dims(shape, self.min_dim)
            if dims is None:
                state["v"][name] = p.new_zeros(shape)
            else:
                d1, d0 = dims
                keep = lambda drop: [s for i, s in enumerate(shape) if i != drop]  # noqa: E731
                state["v_row"][name] = p.new_zeros(keep(d0))
                state["v_col"][name] = p.new_zeros(keep(d1))
        return state

    @torch.no_grad()
    def update(self, grads: Params, state: dict, params: Params, hold=frozenset()) -> dict:
        count = state["count"]
        decay = float(np.float32(1) - np.float32(count + 1) ** np.float32(-self.decay_rate))
        lr = self.schedule(count)
        g_norm = global_norm(grads)
        clip = not bool(g_norm < self.max_grad_norm)
        for name, p in params.items():
            g = grads[name].float()
            if _SHARDS is not None:
                g = _SHARDS.gather(name, g)
            if clip:
                g = (g / g_norm) * self.max_grad_norm
            sq = g * g + self.eps
            if name in state["v"]:
                v = decay * state["v"][name].float() + (1.0 - decay) * sq
                state["v"][name].copy_(v)
                update = g * state["v"][name].float() ** -0.5
            else:
                d1, d0 = _factored_dims(tuple(g.shape), self.min_dim)
                row, col = state["v_row"][name], state["v_col"][name]
                row.copy_(decay * row.float() + (1.0 - decay) * sq.mean(dim=d0))
                col.copy_(decay * col.float() + (1.0 - decay) * sq.mean(dim=d1))
                row_f, col_f = row.float(), col.float()
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (row_f / row_f.mean(dim=reduced_d1, keepdim=True)) ** -0.5
                update = g * row_factor.unsqueeze(d0) * (col_f ** -0.5).unsqueeze(d1)
            if name in hold:
                continue
            rms = torch.sqrt(update.square().mean())
            update = update / torch.clamp(rms / self.clipping_threshold, min=1.0)
            if _SHARDS is not None:
                update = _SHARDS.local(name, update)
            p.copy_(p.float() - (lr * update + self.weight_decay * p.float()))
        state["count"] = count + 1
        return state


class Masked:
    """``optax.multi_transform`` with ``set_to_zero`` for the frozen label:
    ``inner`` sees the parameters and gradients whose mask is true and
    nothing else, so its clip takes the norm of the live gradients only; a
    frozen parameter gets exactly no update."""

    def __init__(self, inner, mask: Dict[str, bool]):
        self.inner, self.mask = inner, dict(mask)

    def _live(self, tree: Params) -> Params:
        return {k: v for k, v in tree.items() if self.mask[k]}

    def init(self, params: Params) -> dict:
        return {"inner": self.inner.init(self._live(params))}

    def update(self, grads: Params, state: dict, params: Params) -> dict:
        state["inner"] = self.inner.update(self._live(grads), state["inner"], self._live(params))
        return state


class ScheduledFreeze:
    """The JAX package's ``scheduled_freeze``: full updates before
    ``start_iter``, mask-only from it on. After the switch the frozen
    gradients are zeroed before ``inner`` (its clip then sees the live set
    only) and the frozen parameters stay where they are, weight decay
    included, while their moments go on decaying as the JAX ones do. On the
    switch step ``inner``'s state is reset to a fresh one."""

    def __init__(self, inner, mask: Dict[str, bool], start_iter: int):
        self.inner, self.mask, self.start_iter = inner, dict(mask), int(start_iter)

    def init(self, params: Params) -> dict:
        return {"inner": self.inner.init(params), "count": 0}

    def update(self, grads: Params, state: dict, params: Params) -> dict:
        count = state["count"]
        hold = frozenset()
        if count >= self.start_iter:
            hold = frozenset(k for k in params if not self.mask[k])
            # a zero of no size, seen at the gradient's shape
            grads = {k: g.new_zeros(()).expand(g.shape) if k in hold else g
                     for k, g in grads.items()}
        if count == self.start_iter:
            state["inner"] = self.inner.init(params)
        state["inner"] = self.inner.update(grads, state["inner"], params, hold=hold)
        state["count"] = count + 1
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


class MasterWeights:
    """f32 master weights under bf16 compute. ``init(params)`` keeps an f32
    master of each tensor: ``start[name]`` where given (the f32 values the
    module was rounded from; used as it is where it is already f32 on the
    tensor's device), else the tensor upcast; an f32 tensor is its own
    master. ``inner`` sees only the masters, so its moments, accumulated
    gradients and counters are what optax holds for f32 parameters: wrap
    ``MultiSteps`` and ``ApplyIfFinite``, not the other way round.
    ``update`` upcasts the gradients, runs ``inner`` on the masters and
    writes each master back into its module tensor (``sync``)."""

    def __init__(self, inner, start: Optional[Params] = None):
        self.inner, self.start = inner, dict(start or {})

    def init(self, params: Params) -> dict:
        masters = {}
        for name, p in params.items():
            if p.dtype == torch.float32:
                masters[name] = p
                continue
            src = self.start.get(name, p)
            if src.shape != p.shape:
                raise ValueError(f"{name}: master of shape {tuple(src.shape)} for a tensor of "
                                 f"{tuple(p.shape)}")
            masters[name] = src.detach().to(p.device, torch.float32)
        state = {"master": masters, "inner": self.inner.init(masters)}
        self.sync(state, params)
        return state

    @torch.no_grad()
    def sync(self, state: dict, params: Params) -> None:
        """Each module tensor := its master, rounded to nearest even."""
        pairs = [(p, state["master"][k]) for k, p in params.items()
                 if p is not state["master"][k]]
        if pairs:
            torch._foreach_copy_([p for p, _ in pairs], [m for _, m in pairs])

    def update(self, grads: Params, state: dict, params: Params) -> dict:
        state["inner"] = self.inner.update({k: g.float() for k, g in grads.items()},
                                           state["inner"], state["master"])
        self.sync(state, params)
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
    mask: Optional[Dict[str, bool]] = None,
    scheduled_mask: Optional[Dict[str, bool]] = None,
    freeze_start_iter: int = -1,
    nan_guard_steps: int = 100,
    optimizer: str = "adamw",
    mu_dtype: Union[str, torch.dtype, None] = None,
):
    """The AdamW (or Adafactor) chain of the JAX package's ``make_optimizer``,
    with its keywords and defaults. ``mask`` (by parameter name) freezes what
    it marks false; else ``scheduled_mask`` does so from update
    ``freeze_start_iter`` on. ``nan_guard_steps`` > 0 wraps the whole in
    ``ApplyIfFinite``; wrap the result in ``MultiSteps`` to accumulate."""
    if isinstance(mu_dtype, str):
        mu_dtype = getattr(torch, mu_dtype)
    schedule = make_schedule(learning_rate, lr_scheduler, lr_warmup_steps, max_train_steps)
    if optimizer == "adafactor":
        tx = Adafactor(schedule, adam_epsilon, adam_weight_decay, max_grad_norm)
    elif optimizer == "adamw":
        tx = AdamW(schedule, adam_beta1, adam_beta2, adam_epsilon, adam_weight_decay,
                   max_grad_norm, mu_dtype)
    else:
        raise ValueError(optimizer)
    if mask is not None:
        tx = Masked(tx, mask)
    elif scheduled_mask is not None:
        tx = ScheduledFreeze(tx, scheduled_mask, freeze_start_iter)
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
