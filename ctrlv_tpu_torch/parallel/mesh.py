"""The (data, frame) mesh of ranks and the collectives the port calls on it.

Counterpart of ``ctrlv_tpu/parallel/mesh.py``. Where the JAX package lays a
``jax.sharding.Mesh`` over devices and lets XLA insert the collectives, the
port runs one process a card (``torchrun``, or a caller's own
``init_process_group``) and calls ``torch.distributed`` itself:

- axis "data": data parallel (training batches, the sampler's samples and
  the overall eval's candidates); the gradients are averaged over it;
- axis "frame": the frames of the sampler's latents; each temporal site of
  the UNet and the ControlNet gathers them over it (``parallel/frames.py``).

Rank ``d * n_frame + f`` sits at (d, f), as the JAX package reshapes its
device list. A mesh above one rank needs the running process group: the
card's ranks take ``nccl``, and ``gloo`` serves only where the caller asked
for the CPU. Every collective the port calls goes through
``all_reduce``/``all_gather`` here and adds one to ``COLLECTIVES``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    data: str = "data"
    frame: str = "frame"


AXES = MeshAxes()
COLLECTIVES = {"all_reduce": 0, "all_gather": 0}


def reset_collective_counts() -> None:
    for name in COLLECTIVES:
        COLLECTIVES[name] = 0


class Mesh:
    """A (data, frame) mesh: a ``DeviceMesh`` over the first n_data * n_frame
    ranks of the process group, or, for a lone process, the 1 x 1 mesh
    without one (whose collectives are the identity)."""

    def __init__(self, n_data: int, n_frame: int, device_mesh=None):
        self.n_data, self.n_frame = int(n_data), int(n_frame)
        self.device_mesh = device_mesh
        coord = (0, 0) if device_mesh is None else device_mesh.get_coordinate()
        self.coordinate = None if coord is None else tuple(int(c) for c in coord)

    @property
    def shape(self) -> dict:
        return {AXES.data: self.n_data, AXES.frame: self.n_frame}

    @property
    def active(self) -> bool:
        """Whether this rank is in the mesh; ranks beyond it sit out."""
        return self.coordinate is not None

    def index(self, axis: str) -> int:
        return self.coordinate[(AXES.data, AXES.frame).index(axis)]

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``; None on the
        mesh without a process group."""
        return None if self.device_mesh is None else self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return f"Mesh(data={self.n_data}, frame={self.n_frame}, at={self.coordinate})"


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def init_from_env(device=None) -> bool:
    """Join the process group that ``torchrun`` describes in the environment
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``):
    ``nccl`` on ``cuda:LOCAL_RANK`` unless ``device`` is the CPU, then
    ``gloo``. A process without ``WORLD_SIZE`` stays alone. True where a
    process group runs after the call."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("gloo" if cpu else "nccl")
    return True


def _device_type() -> str:
    return "cpu" if dist.get_backend() == "gloo" else "cuda"


def make_mesh(n_data: Optional[int] = None, n_frame: int = 1,
              ranks: Optional[int] = None) -> Mesh:
    """A (data, frame) mesh over the first ``ranks`` ranks (default: all of
    the process group). ``n_data=None`` puts every rank left by ``n_frame``
    on the data axis."""
    ranks = world_size() if ranks is None else int(ranks)
    if n_data is None:
        n_data = ranks // n_frame
    if not dist.is_initialized():
        if n_data * n_frame > 1:
            raise RuntimeError(
                f"a {n_data}x{n_frame} mesh needs a process group: launch with torchrun "
                f"--nproc_per_node {n_data * n_frame} (or call init_process_group first)")
        return Mesh(1, 1)
    if n_data * n_frame != ranks:
        raise ValueError(f"mesh {n_data}x{n_frame} != {ranks} ranks")
    if ranks > dist.get_world_size():
        raise ValueError(f"mesh {n_data}x{n_frame} needs {ranks} ranks, the process group "
                         f"has {dist.get_world_size()}")
    from torch.distributed.device_mesh import DeviceMesh

    layout = torch.arange(ranks).reshape(n_data, n_frame)
    return Mesh(n_data, n_frame,
                DeviceMesh(_device_type(), layout, mesh_dim_names=(AXES.data, AXES.frame)))


def train_mesh_shape(global_batch: int, ranks: int, n_data: Optional[int] = None,
                     n_frame: int = 1) -> tuple:
    """(n_data, n_frame) of the training mesh over ``ranks`` ranks, by the
    JAX package's rule: with ``n_data=None`` the largest divisor of the batch
    that fits the ranks left by ``n_frame`` (the surplus ranks sit the steps
    out); an explicit ``n_data`` that does not divide the batch raises."""
    avail = max(ranks // max(n_frame, 1), 1)
    if n_data is None:
        b = max(int(global_batch), 1)
        n_data = max(d for d in range(1, min(avail, b) + 1) if b % d == 0)
    elif global_batch % n_data != 0:
        raise ValueError(
            f"--mesh_data {n_data} does not divide the global batch "
            f"{global_batch}; pick a divisor (or omit --mesh_data to "
            f"auto-select gcd(devices, batch))"
        )
    return n_data, n_frame


def make_train_mesh(global_batch: int, n_data: Optional[int] = None, n_frame: int = 1) -> Mesh:
    """Training mesh whose data axis always divides the global batch
    (``train_mesh_shape``), over the first ranks of the process group."""
    n_data, n_frame = train_mesh_shape(global_batch, world_size(), n_data, n_frame)
    return make_mesh(n_data, n_frame, ranks=n_data * n_frame)


def idle_ranks(mesh: Mesh) -> list:
    """The ranks of the process group outside ``mesh``."""
    return list(range(mesh.n_data * mesh.n_frame, world_size()))


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of ``t`` over ``axis``, in place; the identity on a mesh
    without a process group."""
    group = mesh.group(axis)
    if group is not None:
        COLLECTIVES["all_reduce"] += 1
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str) -> list:
    """Every rank's ``t`` along ``axis``, in rank order; the shapes must be
    equal. ``[t]`` on a mesh without a process group."""
    group = mesh.group(axis)
    if group is None:
        return [t]
    COLLECTIVES["all_gather"] += 1
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return out
