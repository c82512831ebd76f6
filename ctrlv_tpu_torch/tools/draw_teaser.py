"""Teaser figures: several seeds of the two-stage request a clip, box overlays
and the ground-truth 3D-box plots.

    python -m ctrlv_tpu_torch.tools.draw_teaser --dataset_name nuscenes --data_root DIR ...

Counterpart of ``tools/draw_teaser.py`` (the reference's tool of the same
name). For each of the first ``max_samples`` validation clips: ``NUM_SEEDS``
overall requests (30 stage-1 steps, ``--num_inference_steps`` stage-2 steps),
seed ``s`` drawing its noise from its own ``torch.Generator`` seeded with
``cfg.seed + s``; under ``{output_dir}/teaser`` each request's generated
video and winning bbox video as ``sample{i}_seed{s}.gif`` and
``sample{i}_seed{s}_bbox.gif``, every ``F // 5``-th frame of the generated
video max-blended with 0.8 x its bbox frame as
``sample{i}_seed{s}_frame{f}.png``, then the clip's ground-truth box plots at
the dataset's original resolution as ``sample{i}_gt_3d_bbox_frame{f}.png``
(``utils.misc.render_gt_3d_bbox_plots``: 2D boxes only for BDD100K, 3D
wireframes where the samples carry a calibration).

As in the JAX tool, the synthetic dataset means the tiny models and one
UNet serves both stages (``tools.eval_overall.make_pipeline``). The tool runs
on the card unless ``--device`` says otherwise; ``--dataloader_num_workers``
worker processes prepare the clips.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
from PIL import Image

from ..data import get_dataloader
from ..utils.config import Config, parse_args
from ..utils.misc import render_gt_3d_bbox_plots
from ..utils.video_io import export_to_video, frames_to_uint8
from .common import build_models
from .eval_overall import STAGE1_STEPS, make_pipeline

NUM_SEEDS = 3


def draw(pipe, dataset, loader, cfg: Config, max_samples: int = 1) -> list:
    """The figures of the first ``max_samples`` clips of ``loader``. Returns a
    record a clip: its loader wait, each request's seed, seconds, export
    seconds (two GIFs and the overlay PNGs) and mIoU, and the seconds and
    count of its ground-truth plots."""
    out_dir = os.path.join(cfg.output_dir, "teaser")
    os.makedirs(out_dir, exist_ok=True)
    records = []
    batches = iter(loader)
    for i in range(min(max_samples, len(loader))):
        t0 = time.perf_counter()
        batch = next(batches)
        record = dict(loader_wait_seconds=time.perf_counter() - t0, requests=[])
        image, bbox = batch["clips"][0, 0], batch["bbox_images"][0]
        for seed in range(NUM_SEEDS):
            generator = torch.Generator(device=pipe.device).manual_seed(cfg.seed + seed)
            t1 = time.perf_counter()
            result = pipe(
                image, bbox, generator,
                num_frames=cfg.clip_length,
                stage1_steps=STAGE1_STEPS,
                stage2_steps=cfg.num_inference_steps,
                fps=cfg.fps,
                decode_chunk_size=cfg.decode_chunk_size,
            )
            t2 = time.perf_counter()
            export_to_video(
                frames_to_uint8(result["video"]),
                os.path.join(out_dir, f"sample{i}_seed{seed}.gif"), fps=cfg.fps,
            )
            export_to_video(
                frames_to_uint8(result["bbox_video"]),
                os.path.join(out_dir, f"sample{i}_seed{seed}_bbox.gif"), fps=cfg.fps,
            )
            # per-frame overlay: the generated frame max-blended with its bbox frame
            overlay = np.maximum(result["video"], result["bbox_video"] * 0.8)
            for f in range(0, overlay.shape[0], max(overlay.shape[0] // 5, 1)):
                Image.fromarray((overlay[f] * 255).astype(np.uint8)).save(
                    os.path.join(out_dir, f"sample{i}_seed{seed}_frame{f}.png")
                )
            print(f"sample {i} seed {seed}: miou={result['miou']:.3f}", flush=True)
            record["requests"].append(dict(seed=cfg.seed + seed, seconds=t2 - t1,
                                           export_seconds=time.perf_counter() - t2,
                                           miou=result["miou"]))

        # the reference's ground-truth plots: each frame's boxes on a white
        # canvas, plum first frame and gold the rest, at the original resolution
        t3 = time.perf_counter()
        objects = {k: v[0] for k, v in batch["objects"].items()}
        calib = batch.get("cam_to_img")
        plots = render_gt_3d_bbox_plots(
            objects,
            None if calib is None else calib[0],
            dataset.orig_H,
            dataset.orig_W,
            plot_2d_bbox=cfg.dataset_name == "bdd100k",
        )
        for f, plot in enumerate(plots):
            Image.fromarray((plot * 255).astype(np.uint8)).save(
                os.path.join(out_dir, f"sample{i}_gt_3d_bbox_frame{f}.png")
            )
        record.update(plots=len(plots), plot_seconds=time.perf_counter() - t3)
        records.append(record)
    return records


def main(cfg=None, max_samples: int = 1) -> list:
    cfg = cfg or parse_args()
    tiny = cfg.dataset_name == "synthetic"
    models = build_models(cfg, tiny=tiny, with_controlnet=True)
    dataset, loader = get_dataloader(
        cfg.data_root, cfg.dataset_name, if_train=False, batch_size=1,
        num_workers=cfg.dataloader_num_workers,
        clip_length=cfg.clip_length, shuffle=False, if_return_bbox_im=True,
        train_H=cfg.train_H, train_W=cfg.train_W,
        pin_memory=models["device"].type == "cuda",
    )
    return draw(make_pipeline(models), dataset, loader, cfg, max_samples=max_samples)


if __name__ == "__main__":
    main()
