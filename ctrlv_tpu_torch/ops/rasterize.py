"""The bbox rasterizer's palette and projection, in numpy, for the data path.

The port's copy of the host-side pieces of ``ctrlv_tpu/ops/rasterize.py``:
the reference's type palette, the per-track colour hash, the 3D box
projection and the band half-widths of the nuScenes frame. The frames themselves are drawn by the native C++ rasterizer
(``ctrlv_tpu_torch/data/native.py``), which the JAX package's tests hold
against its XLA rasterizer.
"""

from __future__ import annotations

import numpy as np

# Reference palette (plotting.py:10-31), applied to RGB arrays verbatim as
# the reference does (rgb2bgr=False in the dataset path).
TYPE_COLORS = np.asarray(
    [
        (255, 0, 0),      # BLUE (tuple order as reference applies it)
        (255, 255, 255),  # WHITE
        (0, 0, 255),      # RED
        (2, 255, 250),    # YELLOW
        (247, 44, 200),   # PURPLE
        (42, 42, 165),    # BROWN
        (0, 255, 0),      # GREEN
        (44, 162, 247),   # ORANGE
        (255, 153, 204),  # LIGHTPURPLE
        (204, 204, 255),  # LIGHTRED
        (128, 128, 128),  # GRAY
    ],
    dtype=np.float32,
) / 255.0


# Band half-widths (pixels) of the nuScenes frame's lines at the final raster,
# fitted against the reference's matplotlib figure: its lw-2 lines cover about
# 2.5 pixels after the resize to 512 wide, its lw-1 lines about 1.
_HW_3DSTYLE_2 = 1.2
_HW_3DSTYLE_1 = 0.5


def track_color(track_id) -> np.ndarray:
    """Deterministic pseudo-random colour in [50, 255] / 255 per track id,
    (..., 3) float32; the same bits as the JAX package's."""
    x = np.atleast_1d(np.asarray(track_id).astype(np.uint32))
    squeeze = np.ndim(track_id) == 0
    colors = []
    for salt in (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35):
        h = (x + np.uint32(salt)) * np.uint32(0x27D4EB2F)  # wraps, as intended
        h = h ^ (h >> 15)
        h = h * np.uint32(0x165667B1)
        h = h ^ (h >> 13)
        colors.append(50.0 + (h % 206).astype(np.float32))
    if squeeze:
        colors = [c[0] for c in colors]
    # the reference flips the channel order of track colours (REVERT_CHANNEL_F)
    return np.stack(colors[::-1], axis=-1) / 255.0


def project_boxes_3d_np(
    location: np.ndarray,  # (N, 3) camera-space box bottom-centre
    dimensions: np.ndarray,  # (N, 3) (h, w, l)
    rotation_y: np.ndarray,  # (N,)
    cam_to_img: np.ndarray,  # (3, 4) or (3, 3)
) -> np.ndarray:
    """KITTI-convention 3D box corners -> (N, 8, 2) floored image points,
    in the reference's corner order (plotting.py:81-95)."""
    h, w, l = dimensions[:, 0], dimensions[:, 1], dimensions[:, 2]
    cx, cy, cz = location[:, 0], location[:, 1], location[:, 2]
    ry = rotation_y
    corners = []
    for i in (1.0, -1.0):
        for j in (1.0, -1.0):
            for k in (0.0, 1.0):
                px = cx + i * w / 2 * np.cos(-ry + np.pi / 2) + (j * i) * l / 2 * np.cos(-ry)
                pz = cz + i * w / 2 * np.sin(-ry + np.pi / 2) + (j * i) * l / 2 * np.sin(-ry)
                py = cy - k * h
                corners.append(np.stack([px, py, pz], axis=-1))
    pts = np.stack(corners, axis=1)
    if cam_to_img.shape[-1] == 4:
        pts = np.concatenate([pts, np.ones(pts.shape[:-1] + (1,), pts.dtype)], -1)
    proj = np.einsum("rc,nkc->nkr", cam_to_img, pts)
    z = proj[..., 2]
    safe_z = np.where(np.abs(z) > 1e-4, z, 1e-4)
    return np.floor(proj[..., :2] / safe_z[..., None]).astype(np.float32)
