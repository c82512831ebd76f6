"""Teacher-forced Box2Video evaluation: the clip's own bbox frames as the
conditioning.

    python -m ctrlv_tpu_torch.tools.eval_video_controlnet --dataset_name synthetic --device cpu ...

Counterpart of ``tools/eval_video_controlnet.py`` (the reference's tool of
the same name): for each test clip, Box2Video from its first frame and its
bbox frames; SSIM (per frame, averaged) and PSNR against the clip; the
generated and the ground-truth videos exported as GIFs and the clip's
padded labels pickled for detection metrics; the mean of each score at the
end. As in the JAX tool, the synthetic dataset means the tiny models and
``--num_demo_samples`` bounds the clips. One ``torch.Generator`` on the
device, seeded with ``--seed``, draws every clip's noise.
"""

from __future__ import annotations

import os
import pickle
from collections import defaultdict

import numpy as np
import torch

from ..data import get_dataloader
from ..metrics import psnr, ssim
from ..pipelines import StableVideoControlPipeline
from ..utils.config import parse_args
from ..utils.video_io import export_to_video, frames_to_uint8
from .common import build_models


def main(cfg=None, max_samples=None):
    cfg = cfg or parse_args()
    tiny = cfg.dataset_name == "synthetic"
    models = build_models(cfg, tiny=tiny, with_controlnet=True)
    device = models["device"]
    _, loader = get_dataloader(
        cfg.data_root, cfg.dataset_name, if_train=False, batch_size=1,
        num_workers=cfg.dataloader_num_workers,
        clip_length=cfg.clip_length, shuffle=False, if_return_bbox_im=True,
        train_H=cfg.train_H, train_W=cfg.train_W, pin_memory=device.type == "cuda",
    )
    pipe = StableVideoControlPipeline(models["unet"], models["ctrl"], models["vae"],
                                      models["clip"], device=device)
    os.makedirs(cfg.output_dir, exist_ok=True)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    limit = max_samples or cfg.num_demo_samples
    scores = defaultdict(list)
    for i, batch in enumerate(loader):
        if limit and i >= limit:
            break
        gen = pipe(
            batch["clips"][:, 0], batch["bbox_images"], generator=generator,
            num_frames=cfg.clip_length,
            num_inference_steps=cfg.num_inference_steps,
            min_guidance_scale=cfg.min_guidance_scale,
            max_guidance_scale=cfg.max_guidance_scale,
            control_condition_scale=cfg.conditioning_scale,
            fps=cfg.fps,
            noise_aug_strength=cfg.noise_aug_strength,
            decode_chunk_size=cfg.decode_chunk_size,
        )[0].float()
        gt = torch.clamp(batch["clips"][0].to(device) / 2 + 0.5, 0, 1)
        scores["ssim"].append(float(np.mean([float(ssim(gen[f], gt[f]))
                                             for f in range(gen.shape[0])])))
        scores["psnr"].append(float(psnr(gen, gt)))
        print(f"[{i}] ssim={scores['ssim'][-1]:.3f} psnr={scores['psnr'][-1]:.2f}", flush=True)
        export_to_video(frames_to_uint8(gen.cpu().numpy()),
                        os.path.join(cfg.output_dir, f"generated_video_{i}.gif"), fps=cfg.fps)
        export_to_video(frames_to_uint8(gt.cpu().numpy()),
                        os.path.join(cfg.output_dir, f"gt_video_{i}.gif"), fps=cfg.fps)
        with open(os.path.join(cfg.output_dir, f"gt_labels_{i}.pkl"), "wb") as f:
            pickle.dump({"objects": {k: v.numpy() for k, v in batch["objects"].items()},
                         "index": batch["indices"]}, f)
    summary = {k: float(np.mean(v)) for k, v in scores.items()}
    print("summary:", summary)
    return summary


if __name__ == "__main__":
    main()
