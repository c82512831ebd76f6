"""Odds and ends of the trainers and the teaser tool.

The port's counterpart of ``ctrlv_tpu/utils/misc.py`` (the reference's
``utils/util.py:31-35,172-175`` and ``utils/plotting.py:147-180``):
``rand_log_normal``, caption tokenization, the W&B gate and its frame helpers
(None or [] where ``wandb`` is absent), and the teaser's ground-truth box
plots, drawn by the native rasterizer.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def rand_log_normal(generator: torch.Generator, shape, loc: float = 0.0, scale: float = 1.0):
    """Log-normal samples, f32 on the generator's device, by the inverse CDF
    of uniform draws in [1e-7, 1 - 1e-7], as the JAX function draws them."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = u * (1 - 2e-7) + 1e-7
    return torch.exp(torch.special.ndtri(u) * scale + loc)


def tokenize_captions(batch_prompts: List[str], tokenizer) -> torch.Tensor:
    """A Hugging Face tokenizer's input ids, padded to its max length."""
    inputs = tokenizer(
        batch_prompts,
        max_length=tokenizer.model_max_length,
        padding="max_length",
        truncation=True,
        return_tensors="pt",
    )
    return inputs.input_ids


def wandb_available() -> bool:
    try:
        import wandb  # noqa: F401

        return True
    except ImportError:
        return False


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tensor2wandbimage(frame, bbox_tensor=None, track_ids=None, caption=None):
    """A ``wandb.Image`` with its boxes overlaid; None where wandb is absent."""
    if not wandb_available():
        return None
    import wandb

    if bbox_tensor is None:
        return wandb.Image(_numpy(frame), caption=caption)
    box_data = [
        {
            "position": {
                "minX": float(b[0]), "minY": float(b[1]),
                "maxX": float(b[2]), "maxY": float(b[3]),
            },
            "class_id": int(t),
        }
        for b, t in zip(_numpy(bbox_tensor), _numpy(track_ids))
    ]
    return wandb.Image(
        _numpy(frame),
        boxes={"ground__truth": {"box_data": box_data}},
        caption=caption,
    )


def wandb_frames_with_bbox(video, objects=None, image_size=(1242, 375)):
    """One ``wandb.Image`` a frame of ``video`` (F, H, W, 3), with the first
    sample's boxes of ``objects`` in [0, 1] coordinates; [] where wandb is
    absent."""
    if not wandb_available():
        return []
    from .fourier import rescale_bbox

    video = _numpy(video)
    frames = []
    for f in range(video.shape[0]):
        if objects is not None:
            boxes = _numpy(rescale_bbox(objects["bbox"][0][f], image_size, (1, 1)))
            tracks = _numpy(objects["track_id"][0][f])
            frames.append(tensor2wandbimage(video[f], boxes, tracks, caption=f"Frame {f}"))
        else:
            frames.append(tensor2wandbimage(video[f], caption=f"Frame {f}"))
    return frames


def render_gt_3d_bbox_plots(objects, cam_to_img, orig_h, orig_w, plot_2d_bbox=False):
    """The reference's teaser plots: each frame's 3D-box wireframes on a white
    canvas, frame 0 in plum and the later frames in gold.

    As the reference's ``tools/draw_teaser.py:229-240``: a white canvas of
    (orig_h, orig_w); the colour is CSS plum or gold with its channels
    reversed, as the reference applies it to the RGB canvas; the 2D boxes in
    track colours only where ``plot_2d_bbox`` (BDD100K). Drawn by the native
    rasterizer: against the JAX package's XLA rasterizer, edge pixels may
    differ.

    objects: one sample's (F, N, ...) padded arrays (a collated batch's
    ``objects`` at one batch index), numpy or tensors; cam_to_img: (3, 4),
    (3, 3) or None. Returns (orig_h, orig_w, 3) float32 frames in [0, 1].
    """
    from ..data.native import rasterize_frame_native
    from ..ops.rasterize import project_boxes_3d_np, track_color

    objects = {k: _numpy(v) for k, v in objects.items()}
    plum = np.asarray([221, 160, 221], np.float32)[::-1] / 255.0
    gold = np.asarray([255, 215, 0], np.float32)[::-1] / 255.0

    f_total, n = objects["bbox"].shape[:2]
    white = np.ones((orig_h, orig_w, 3), np.float32)
    calib = None
    if cam_to_img is not None:
        calib = _numpy(cam_to_img).astype(np.float32)
        if calib.shape != (3, 4):
            calib = np.pad(calib, ((0, 0), (0, 1)))
    frames = []
    for f in range(f_total):
        color = plum if f == 0 else gold
        if calib is not None:
            corners = project_boxes_3d_np(
                objects["locations"][f], objects["dimensions"][f],
                objects["rotation_y"][f], calib,
            )
        else:
            corners = np.full((n, 8, 2), -1e4, np.float32)
        valid = np.arange(n) < objects["num_objects"][f]
        tcol = np.tile(color[None], (n, 1)).astype(np.float32)
        kcol = np.asarray(track_color(objects["track_id"][f]), np.float32)
        frames.append(rasterize_frame_native(
            corners, objects["bbox"][f], valid, tcol, kcol, height=orig_h, width=orig_w,
            background=white, plot_2d_bbox=plot_2d_bbox,
        ))
    return frames
