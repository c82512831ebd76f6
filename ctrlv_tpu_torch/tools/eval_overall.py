"""Full two-stage evaluation: bbox prediction (5 candidates) + Box2Video.

    python -m ctrlv_tpu_torch.tools.eval_overall --dataset_name synthetic --device cpu ...

Counterpart of ``tools/eval_overall.py`` (the reference's
``tools/eval_overall.py``). For each test clip: five stage-1 bbox videos
over the guidance pairs in one batch, darkness cleanup, the best by mask
IoU against the clip's bbox frames, Box2Video on the winner; the six scores
with their running means, the generated and the predicted-bbox videos
exported as GIFs, and a summary of (mean, std) per score at the end.

As in the JAX tool: the synthetic dataset means the tiny models, stage 1
takes 30 steps and stage 2 ``--num_inference_steps``, and one UNet serves
both stages. One ``torch.Generator`` on the device, seeded with ``--seed``,
draws every sample's noise. The tool runs on the card unless ``--device``
says otherwise; ``--dataloader_num_workers`` worker processes prepare the
clips while the card samples.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict

import numpy as np
import torch

from ..data import get_dataloader
from ..pipelines import OverallPipeline, StableVideoControlPipeline, VideoDiffusionPipeline
from ..utils.config import Config, parse_args
from ..utils.video_io import export_to_video, frames_to_uint8
from .common import build_models

SCORES = ("miou", "ap", "ar", "miou_first_last", "ap_first_last", "ar_first_last")
STAGE1_STEPS = 30


def make_pipeline(models) -> OverallPipeline:
    """The two stages over one set of models: the same UNet in both."""
    device = models["device"]
    bbox = VideoDiffusionPipeline(models["unet"], models["vae"], models["clip"], device=device)
    ctrl = StableVideoControlPipeline(models["unet"], models["ctrl"], models["vae"],
                                      models["clip"], device=device)
    return OverallPipeline(bbox, ctrl)


def evaluate(pipe: OverallPipeline, loader, cfg: Config, max_samples=None, export: bool = True):
    """Run the loop over ``loader``; returns (summary, samples): the summary
    maps each score to its (mean, std), and each sample's record holds its
    scores, its best guidance pair, the pipeline's seconds, the seconds the
    loop waited on the loader for it and the seconds of its export."""
    if export:
        os.makedirs(cfg.output_dir, exist_ok=True)
    generator = torch.Generator(device=pipe.device).manual_seed(cfg.seed)
    scores, samples = defaultdict(list), []
    batches = iter(loader)
    for i in range(len(loader)):
        if (max_samples is not None and i >= max_samples) or (
                cfg.num_demo_samples and i >= cfg.num_demo_samples):
            break
        t0 = time.perf_counter()
        batch = next(batches)
        t1 = time.perf_counter()
        result = pipe(
            batch["clips"][0, 0], batch["bbox_images"][0], generator,
            num_frames=cfg.clip_length,
            stage1_steps=STAGE1_STEPS,
            stage2_steps=cfg.num_inference_steps,
            fps=cfg.fps,
            noise_aug_strength=cfg.noise_aug_strength,
            num_cond_bbox_frames=cfg.num_cond_bbox_frames,
            min_guidance_scale=cfg.min_guidance_scale,
            max_guidance_scale=cfg.max_guidance_scale,
            control_condition_scale=cfg.conditioning_scale,
            decode_chunk_size=cfg.decode_chunk_size,
            max_decode_frames=cfg.max_decode_frames,
        )
        t2 = time.perf_counter()
        for k in SCORES:
            scores[k].append(result[k])
        print(
            f"[{i}] miou={result['miou']:.3f} ap={result['ap']:.3f} "
            f"ar={result['ar']:.3f} avg_miou={np.mean(scores['miou']):.3f} "
            f"best_guidance={result['best_guidance']} ({t2 - t1:.3f} s, loader wait "
            f"{t1 - t0:.3f} s)", flush=True
        )
        if export:
            export_to_video(
                frames_to_uint8(result["video"]),
                os.path.join(cfg.output_dir, f"generated_video_{i}.gif"), fps=cfg.fps,
            )
            export_to_video(
                frames_to_uint8(result["bbox_video"]),
                os.path.join(cfg.output_dir, f"predicted_bbox_{i}.gif"), fps=cfg.fps,
            )
        samples.append(dict({k: result[k] for k in SCORES}, best_guidance=result["best_guidance"],
                            seconds=t2 - t1, loader_wait_seconds=t1 - t0,
                            export_seconds=time.perf_counter() - t2))

    summary = {k: (float(np.mean(v)), float(np.std(v))) for k, v in scores.items()}
    print("summary (mean, std):", summary)
    return summary, samples


def main(cfg=None, max_samples=None):
    cfg = cfg or parse_args()
    tiny = cfg.dataset_name == "synthetic"
    models = build_models(cfg, tiny=tiny, with_controlnet=True)
    _, loader = get_dataloader(
        cfg.data_root, cfg.dataset_name, if_train=False, batch_size=1,
        num_workers=cfg.dataloader_num_workers,
        clip_length=cfg.clip_length, shuffle=False, if_return_bbox_im=True,
        train_H=cfg.train_H, train_W=cfg.train_W,
        use_segmentation=cfg.use_segmentation,
        if_last_frame_traj=cfg.if_last_frame_trajectory,
        pin_memory=models["device"].type == "cuda",
    )
    return evaluate(make_pipeline(models), loader, cfg, max_samples=max_samples)[0]


if __name__ == "__main__":
    main()
