"""Evaluate the stage-1 bbox predictor with the clip's own conditioning frames.

    python -m ctrlv_tpu_torch.tools.eval_video_bbox_prediction --dataset_name synthetic --device cpu ...

Counterpart of ``tools/eval_video_bbox_prediction.py`` (the reference's tool
of the same name). For each test clip: the stage-1 sampler from its first
frame, with its ground-truth bbox frames as the conditioning (latent
substitution of the first ``--num_cond_bbox_frames`` and the last); the
clip's mask IoU against those frames and the mean per-frame boundary F of
the reference's protocol (``metrics.fandj.stage1_frame_f_measure``); the
predicted bbox video exported as ``pred_bbox_{i}.gif``; the mean of each
score at the end.

As in the JAX tool, the synthetic dataset means the tiny models and
``--num_demo_samples`` bounds the clips. One ``torch.Generator`` on the
device, seeded with ``--seed``, draws every clip's noise. The tool runs on
the card unless ``--device`` says otherwise; ``--dataloader_num_workers``
worker processes prepare the clips while the card samples.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict

import numpy as np
import torch

from ..data import get_dataloader
from ..metrics import binary_mask_iou, stage1_frame_f_measure
from ..pipelines import VideoDiffusionPipeline
from ..utils.config import Config, parse_args
from ..utils.video_io import export_to_video, frames_to_uint8
from .common import build_models

SCORES = ("miou", "f_measure")


def make_pipeline(models) -> VideoDiffusionPipeline:
    return VideoDiffusionPipeline(models["unet"], models["vae"], models["clip"],
                                  device=models["device"])


def score_clip(gen: np.ndarray, bbox: np.ndarray) -> dict:
    """The scores of one generated clip (F, H, W, 3) in [0, 1] against its
    bbox frames (F, H, W, 3) in [-1, 1], on the host as in the JAX tool:
    mask IoU over the clip, and the mean of the per-frame boundary F."""
    gt = np.clip(bbox / 2 + 0.5, 0, 1)
    miou, _, _ = binary_mask_iou((gt * 255).astype(np.uint8), (gen * 255).astype(np.uint8))
    gt_u8 = (gt * 255.0).astype(np.uint8)
    fs = [stage1_frame_f_measure(gen[f], gt_u8[f]) for f in range(gen.shape[0])]
    return {"miou": miou, "f_measure": float(np.mean(fs))}


def evaluate(pipe, loader, cfg: Config, max_samples=None, export: bool = True):
    """Run the loop over ``loader``; returns (summary, samples): the summary
    maps each score to its mean, and each sample's record holds its scores,
    the pipeline's seconds, the seconds the loop waited on the loader for
    it, the scoring's seconds and the export's."""
    if export:
        os.makedirs(cfg.output_dir, exist_ok=True)
    generator = torch.Generator(device=pipe.device).manual_seed(cfg.seed)
    limit = max_samples or cfg.num_demo_samples
    scores, samples = defaultdict(list), []
    batches = iter(loader)
    for i in range(len(loader)):
        if limit and i >= limit:
            break
        t0 = time.perf_counter()
        batch = next(batches)
        t1 = time.perf_counter()
        frames = pipe(
            batch["clips"][:, 0], bbox_images=batch["bbox_images"], generator=generator,
            num_frames=cfg.clip_length,
            num_inference_steps=cfg.num_inference_steps,
            min_guidance_scale=cfg.min_guidance_scale,
            max_guidance_scale=cfg.max_guidance_scale,
            fps=cfg.fps,
            noise_aug_strength=cfg.noise_aug_strength,
            num_cond_bbox_frames=cfg.num_cond_bbox_frames,
            decode_chunk_size=cfg.decode_chunk_size,
        )[0]
        gen = frames.float().cpu().numpy()
        t2 = time.perf_counter()
        score = score_clip(gen, batch["bbox_images"][0].numpy())
        t3 = time.perf_counter()
        for k in SCORES:
            scores[k].append(score[k])
        print(f"[{i}] miou={score['miou']:.3f} F={score['f_measure']:.3f} "
              f"avg_miou={np.mean(scores['miou']):.3f} ({t2 - t1:.3f} s, loader wait "
              f"{t1 - t0:.3f} s, scoring {t3 - t2:.3f} s)", flush=True)
        if export:
            export_to_video(frames_to_uint8(gen),
                            os.path.join(cfg.output_dir, f"pred_bbox_{i}.gif"), fps=cfg.fps)
        samples.append(dict(score, seconds=t2 - t1, loader_wait_seconds=t1 - t0,
                            scoring_seconds=t3 - t2, export_seconds=time.perf_counter() - t3))
    summary = {k: float(np.mean(v)) for k, v in scores.items()}
    print("summary:", summary)
    return summary, samples


def main(cfg=None, max_samples=None):
    cfg = cfg or parse_args()
    tiny = cfg.dataset_name == "synthetic"
    models = build_models(cfg, tiny=tiny)
    _, loader = get_dataloader(
        cfg.data_root, cfg.dataset_name, if_train=False, batch_size=1,
        num_workers=cfg.dataloader_num_workers,
        clip_length=cfg.clip_length, shuffle=False, if_return_bbox_im=True,
        train_H=cfg.train_H, train_W=cfg.train_W, pin_memory=models["device"].type == "cuda",
    )
    return evaluate(make_pipeline(models), loader, cfg, max_samples=max_samples)[0]


if __name__ == "__main__":
    main()
