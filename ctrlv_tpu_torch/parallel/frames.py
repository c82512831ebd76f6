"""Frame-sharded activations of the UNet and the ControlNet.

The port's counterpart of the JAX package's ``maybe_shard_frames``
(``ctrlv_tpu/pipelines/common.py``): under a mesh with a frame axis above
one, each rank of a frame group holds a contiguous share of the clip's
frames (25 over 2 ranks: 13 + 12). The spatial layers are frame-local and
run on the share. The two temporal sites, ``SpatioTemporalResBlock`` (whose
temporal GroupNorm spans every frame) and ``TransformerSpatioTemporalModel``,
gather the frame axis over the group, run on all F frames and keep their own
share: the temporal work is repeated on each frame rank. A sampler sets the
shard around its model calls with ``frame_sharded``; the models read it with
``current_frame_shard`` and take no extra argument.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from .mesh import AXES, Mesh
from .sharding import gather_shares, shares


class FrameShard:
    """``frames`` frames split over the mesh's frame axis: this rank computes
    frames ``[lo, hi)``. Tensors are (B*F_local, ...) on the rank and
    (B*F, ...) gathered, frame-major within each sample."""

    def __init__(self, mesh: Mesh, frames: int):
        self.mesh, self.frames = mesh, int(frames)
        self.bounds = shares(self.frames, mesh.n_frame)
        if any(hi == lo for lo, hi in self.bounds):
            raise ValueError(f"{frames} frames do not cover a frame axis of {mesh.n_frame}")
        self.lo, self.hi = self.bounds[mesh.index(AXES.frame)]

    @property
    def local(self) -> int:
        return self.hi - self.lo

    def gather(self, x: torch.Tensor, batch: int) -> torch.Tensor:
        """(B*F_local, ...) on each rank -> (B*F, ...) on every rank."""
        rest = x.shape[1:]
        full = gather_shares(x.reshape((batch, self.local) + rest), self.mesh, AXES.frame,
                             self.bounds, dim=1)
        return full.reshape((batch * self.frames,) + rest)

    def take(self, x: torch.Tensor, batch: int) -> torch.Tensor:
        """(B*F, ...) -> this rank's (B*F_local, ...), contiguous."""
        rest = x.shape[1:]
        xl = x.reshape((batch, self.frames) + rest)[:, self.lo:self.hi]
        return xl.reshape((batch * self.local,) + rest).contiguous()

    def local_frames(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's frames of a (B, F, ...) tensor."""
        return x[:, self.lo:self.hi]


_CURRENT: Optional[FrameShard] = None


@contextlib.contextmanager
def frame_sharded(shard: Optional[FrameShard]):
    """Inside this block the UNet and the ControlNet take (B, F_local, ...)
    inputs and gather frames at their temporal sites. ``None`` changes
    nothing."""
    global _CURRENT
    prev, _CURRENT = _CURRENT, shard
    try:
        yield
    finally:
        _CURRENT = prev


def current_frame_shard() -> Optional[FrameShard]:
    return _CURRENT
