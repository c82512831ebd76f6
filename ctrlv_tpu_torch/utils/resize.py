"""Image resizes as ``jax.image.resize`` computes them.

``jax.image.resize`` antialiases on a downscale: its kernel is widened by
in/out, so every input pixel under it counts. Two of its methods reach the
port:

- ``"bicubic"`` (CLIP's preprocessing) is Keys cubic with a = -0.5;
  ``F.interpolate(mode="bicubic")`` uses a = -0.75 and differs, so
  ``resize_matrix`` builds JAX's weights and the caller applies them as two
  matmuls;
- ``"bilinear"`` (FVD's preprocessing and the offline eval's frames) is a
  triangle kernel, which ``F.interpolate(mode="bilinear", antialias=True)``
  computes too, to f32 rounding.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys cubic kernel with a = -0.5 on |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) f32 weights of an antialiased Keys-cubic resize, built as
    ``jax.image.scale_and_translate`` builds them (scale out/in, no
    translation): on a downscale the kernel is widened by in/out."""
    if in_size == out_size:  # jax.image.resize leaves such an axis as it is
        return np.eye(in_size, dtype=np.float32)
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = (np.arange(out_size, dtype=np.float32) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = _keys_cubic(x.astype(np.float32)).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    ok = np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps)
    w = np.where(ok, w / np.where(total != 0, total, 1), 0).astype(np.float32)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resize_bilinear(frames: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(..., H, W, C) -> (..., h, w, C) for ``size = (h, w)``, bilinear and
    antialiased on a downscale, as ``jax.image.resize(..., "bilinear")``;
    f32."""
    *lead, h, w, c = frames.shape
    x = frames.float().reshape(-1, h, w, c).permute(0, 3, 1, 2)
    if (h, w) != tuple(size):
        x = F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False,
                          antialias=True)
    return x.permute(0, 2, 3, 1).reshape(*lead, *size, c).contiguous()
