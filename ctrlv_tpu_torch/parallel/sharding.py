"""Which part of the batch and of the optimizer state a rank holds.

Counterpart of ``ctrlv_tpu/parallel/sharding.py``. The JAX package annotates
arrays with ``NamedSharding``s and lets XLA place them; here a rank holds
its part and the collectives of ``parallel/mesh.py`` move the rest:

- ``replicate`` and ``data_parallel_sharding`` say which rows of a global
  batch a rank computes: all of them, or its data index's even share;
- ``shares`` splits an axis contiguously into parts that may differ by one
  (25 frames over 2 ranks are 13 + 12), as the JAX partitioner pads them;
- ``zero1_plan`` is the JAX ``zero1_sharding_tree`` rule: the largest
  dimension divisible by the data axis, where the tensor has at least
  ``min_size`` elements;
- ``shard_train_state`` keeps on each data rank only its slice of AdamW's
  moments, ``MultiSteps``' accumulated gradient and ``MasterWeights``' f32
  masters (ZeRO-1); ``Zero1`` is the plan that the training steps and the
  optimizers read while they update (``train/state.py``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .mesh import AXES, Mesh, all_gather, all_reduce

# the optimizer-state entries that hold one tensor of each parameter's shape
# and that ZeRO-1 slices; Adafactor's factored statistics stay whole
SHARDED_STATE = ("mu", "nu", "acc_grads", "master")


def shares(n_items: int, n_parts: int) -> list:
    """(lo, hi) of each of ``n_parts`` contiguous parts of ``n_items``: the
    first ``n_items % n_parts`` parts one longer."""
    base, extra = divmod(int(n_items), int(n_parts))
    bounds, lo = [], 0
    for i in range(n_parts):
        hi = lo + base + (1 if i < extra else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def gather_shares(x: torch.Tensor, mesh: Mesh, axis: str, bounds: list,
                  dim: int) -> torch.Tensor:
    """The whole of a tensor's ``dim`` from every rank's share of it along
    the mesh's ``axis`` (``bounds`` as ``shares`` gives them). The shares are
    padded to the longest one for ``all_gather`` and the pad dropped."""
    per = max(hi - lo for lo, hi in bounds)
    if x.shape[dim] < per:
        pad = list(x.shape)
        pad[dim] = per - x.shape[dim]
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    parts = all_gather(x, mesh, axis)
    return torch.cat([p.narrow(dim, 0, hi - lo) for p, (lo, hi) in zip(parts, bounds)], dim=dim)


def replicate(mesh: Mesh, batch: int) -> slice:
    """Every row of the batch: what a replicated tensor's rank holds."""
    return slice(0, batch)


def data_parallel_sharding(mesh: Mesh, batch: int) -> slice:
    """The rows of a global training batch that this rank's data index
    computes. The training mesh's data axis divides the batch."""
    n = mesh.n_data
    if batch % n:
        raise ValueError(f"batch {batch} does not split over a data axis of {n}")
    per = batch // n
    d = mesh.index(AXES.data)
    return slice(d * per, (d + 1) * per)


def zero1_plan(named_shapes: Dict[str, tuple], n: int, min_size: int = 2**14) -> dict:
    """{name: the axis to shard over a data axis of ``n``, or None to
    replicate}: the largest dimension divisible by ``n`` (the last of equal
    ones), for tensors of at least ``min_size`` elements."""
    plan = {}
    for name, shape in named_shapes.items():
        shape = tuple(int(s) for s in shape)
        size = 1
        for s in shape:
            size *= s
        divisible = [(d, i) for i, d in enumerate(shape) if d % n == 0 and d >= n]
        plan[name] = None if n <= 1 or size < min_size or not divisible else max(divisible)[1]
    return plan


class Zero1:
    """The ZeRO-1 plan of one train state over a mesh's data axis: which
    parameters are sliced, along which axis, and this rank's slice."""

    def __init__(self, plan: Dict[str, Optional[int]], mesh: Mesh):
        self.axes = {k: a for k, a in plan.items() if a is not None}
        self.mesh = mesh
        self.n = mesh.n_data
        self.index = mesh.index(AXES.data)

    def __contains__(self, name: str) -> bool:
        return name in self.axes

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a full tensor of ``name``'s shape (a view),
        or the tensor itself where ``name`` is replicated."""
        axis = self.axes.get(name)
        if axis is None:
            return t
        per = t.shape[axis] // self.n
        return t.narrow(axis, self.index * per, per)

    def full_shape(self, name: str, t: torch.Tensor) -> tuple:
        """The shape of the whole tensor of which ``t`` is this rank's slice."""
        shape = list(t.shape)
        if name in self.axes:
            shape[self.axes[name]] *= self.n
        return tuple(shape)

    def local_dict(self, tensors: Dict[str, torch.Tensor]) -> dict:
        return {k: self.local(k, t) for k, t in tensors.items()}

    def gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The full tensor of ``name`` from every data rank's slice ``t``."""
        axis = self.axes.get(name)
        if axis is None:
            return t
        return torch.cat(all_gather(t, self.mesh, AXES.data), dim=axis)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data axis, in place."""
        return all_reduce(t, self.mesh, AXES.data)

    @torch.no_grad()
    def gather_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Each sliced parameter made whole on every rank from the slices the
        data ranks updated."""
        for name, p in params.items():
            if name in self.axes:
                p.copy_(self.gather(name, self.local(name, p)))

    def _map_state(self, tree, fn):
        if not isinstance(tree, dict):
            return tree
        out = {}
        for key, value in tree.items():
            if key in SHARDED_STATE and isinstance(value, dict):
                out[key] = {k: fn(k, t) for k, t in value.items()}
            else:
                out[key] = self._map_state(value, fn)
        return out

    def shard_state(self, opt_state: dict) -> dict:
        """The optimizer state with each sliced entry cut to this rank's
        slice (a copy: it no longer shares memory with the full tensor)."""
        return self._map_state(opt_state, lambda k, t: self.local(k, t).clone()
                               if k in self.axes else t)

    def gather_state(self, opt_state: dict) -> dict:
        """The optimizer state with every sliced entry made whole: what one
        rank holds, as a checkpoint saves it."""
        return self._map_state(opt_state, self.gather)


def shard_train_state(state, mesh: Mesh, zero1: bool = False, min_size: int = 2**14):
    """Lay a TrainState on the mesh: the parameters and the step stay whole
    on every rank; with ``zero1`` each data rank keeps only its slice of the
    optimizer state the plan shards (``state.shards``). A data axis of one
    shards nothing."""
    state.shards = None
    if not zero1 or mesh.n_data <= 1:
        return state
    shards = Zero1(zero1_plan({k: tuple(p.shape) for k, p in state.params.items()},
                              mesh.n_data, min_size), mesh)
    if shards.axes:
        state.opt_state = shards.shard_state(state.opt_state)
        state.shards = shards
    return state


def gathered_opt_state(state) -> dict:
    """The whole optimizer state of a TrainState, sliced by ZeRO-1 or not.
    Every data rank must call it: it gathers."""
    return state.opt_state if state.shards is None else state.shards.gather_state(state.opt_state)
