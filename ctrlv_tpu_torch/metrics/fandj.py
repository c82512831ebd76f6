"""DAVIS J&F: region Jaccard and boundary F-measure, and the stage-1 eval's
per-frame boundary F.

The port's own copy of ``ctrlv_tpu/metrics/fandj.py`` (the reference's
``metrics/FandJ.py:43-215``), numpy alone and bit-equal to it:
``db_eval_iou`` scores an empty union 1; ``f_measure`` matches 1-px boundary
maps dilated by a disk of radius ceil(0.008·||shape||), the disk dilation a
sliding-window maximum in place of cv2.
"""

from __future__ import annotations

import numpy as np


def db_eval_iou(annotation, segmentation, void_pixels=None):
    """Region similarity (Jaccard). Supports (H,W) or (F,H,W)."""
    annotation = np.asarray(annotation).astype(bool)
    segmentation = np.asarray(segmentation).astype(bool)
    assert annotation.shape == segmentation.shape
    if void_pixels is None:
        void = np.zeros_like(segmentation)
    else:
        void = np.asarray(void_pixels).astype(bool)
    inters = np.sum((segmentation & annotation) & ~void, axis=(-2, -1))
    union = np.sum((segmentation | annotation) & ~void, axis=(-2, -1))
    j = inters / np.where(union == 0, 1, union)
    j = np.where(np.isclose(union, 0), 1.0, j)
    return float(j) if j.ndim == 0 else j


def _seg2bmap(seg: np.ndarray) -> np.ndarray:
    """1-px-wide boundary map, offset 1/2 px toward the origin."""
    seg = np.asarray(seg).astype(bool)
    e = np.zeros_like(seg)
    s = np.zeros_like(seg)
    se = np.zeros_like(seg)
    e[:, :-1] = seg[:, 1:]
    s[:-1, :] = seg[1:, :]
    se[:-1, :-1] = seg[1:, 1:]
    b = (seg ^ e) | (seg ^ s) | (seg ^ se)
    b[-1, :] = seg[-1, :] ^ e[-1, :]
    b[:, -1] = seg[:, -1] ^ s[:, -1]
    b[-1, -1] = False
    return b


def _disk_dilate(mask: np.ndarray, radius: int) -> np.ndarray:
    """Binary dilation by a disk structuring element (numpy sliding max)."""
    if radius <= 0:
        return mask.copy()
    h, w = mask.shape
    padded = np.zeros((h + 2 * radius, w + 2 * radius), dtype=bool)
    padded[radius : radius + h, radius : radius + w] = mask
    out = np.zeros_like(mask)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dy * dy + dx * dx <= radius * radius:
                out |= padded[radius + dy : radius + dy + h, radius + dx : radius + dx + w]
    return out


def f_measure(foreground_mask, gt_mask, void_pixels=None, bound_th: float = 0.008):
    """Boundary F-measure between two binary masks (single frame)."""
    fg = np.asarray(foreground_mask)
    gt = np.asarray(gt_mask)
    if void_pixels is None:
        void = np.zeros_like(fg, dtype=bool)
    else:
        void = np.asarray(void_pixels).astype(bool)
    bound_pix = (
        bound_th
        if bound_th >= 1
        else int(np.ceil(bound_th * np.linalg.norm(fg.shape)))
    )
    fg_boundary = _seg2bmap(fg * ~void)
    gt_boundary = _seg2bmap(gt * ~void)
    fg_dil = _disk_dilate(fg_boundary, int(bound_pix))
    gt_dil = _disk_dilate(gt_boundary, int(bound_pix))

    gt_match = gt_boundary & fg_dil
    fg_match = fg_boundary & gt_dil
    n_fg = fg_boundary.sum()
    n_gt = gt_boundary.sum()
    if n_fg == 0 and n_gt > 0:
        precision, recall = 1.0, 0.0
    elif n_fg > 0 and n_gt == 0:
        precision, recall = 0.0, 1.0
    elif n_fg == 0 and n_gt == 0:
        precision, recall = 1.0, 1.0
    else:
        precision = fg_match.sum() / float(n_fg)
        recall = gt_match.sum() / float(n_gt)
    if precision + recall == 0:
        return 0.0
    return 2.0 * precision * recall / (precision + recall)


def pil_luma_uint8(rgb: np.ndarray) -> np.ndarray:
    """PIL Image.convert('L') luma, bit-exact: (H,W,3) uint8 -> (H,W) uint8.

    ITU-R 601-2 fixed-point exactly as PIL's ImageConvert.c L24/L macros:
    L = (R*19595 + G*38470 + B*7471 + 0x8000) >> 16. The stage-1 f-measure
    protocol converts frames through PIL grayscale before scoring
    (the reference's ``tools/eval_video_bbox_prediction.py:85-96``), so parity
    requires this exact rounding, not a float luma.
    """
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.shape[-1] != 3:
        raise ValueError(f"expected (..., 3) uint8, got {rgb.shape} {rgb.dtype}")
    r = rgb[..., 0].astype(np.uint32)
    g = rgb[..., 1].astype(np.uint32)
    b = rgb[..., 2].astype(np.uint32)
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def stage1_frame_f_measure(gen_frame: np.ndarray, gt_frame_uint8: np.ndarray) -> float:
    """Boundary F for one generated frame vs a GT bbox frame, using the
    reference protocol (the reference's ``tools/eval_video_bbox_prediction.py``):
      1. zero generated pixels darker than 5/255 (float domain),
      2. float [0,1] -> uint8 by truncation (torchvision to_pil_image),
      3. PIL grayscale ('L'); GT uint8 frame likewise,
      4. f_measure on the grayscale images' nonzero support (no extra
         threshold — _seg2bmap binarizes by astype(bool)).
    gen_frame: (H,W,3) float in [0,1]; gt_frame_uint8: (H,W,3) uint8.
    """
    gen = np.where(gen_frame < 5.0 / 255.0, 0.0, gen_frame)
    gen_u8 = (gen * 255.0).astype(np.uint8)  # trunc, = tensor.mul(255).byte()
    return f_measure(pil_luma_uint8(gen_u8), pil_luma_uint8(gt_frame_uint8))


def db_eval_boundary(annotation, segmentation, void_pixels=None, bound_th=0.008):
    """Per-frame boundary F over (F,H,W) stacks or a single (H,W) frame."""
    annotation = np.asarray(annotation)
    segmentation = np.asarray(segmentation)
    assert annotation.shape == segmentation.shape
    if annotation.ndim == 3:
        return np.array(
            [
                f_measure(
                    segmentation[i],
                    annotation[i],
                    None if void_pixels is None else void_pixels[i],
                    bound_th,
                )
                for i in range(annotation.shape[0])
            ]
        )
    return f_measure(segmentation, annotation, void_pixels, bound_th)
