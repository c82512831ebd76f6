"""Training observability: scalar and media tracking, in-loop validation.

Counterpart of ``ctrlv_tpu/train/observability.py`` (the reference's W&B
loop: validation every ``validation_steps`` over ``num_demo_samples`` cached
samples, per-step scalars, media logs). The tracker is W&B where
``report_to == "wandb"`` and the package imports, otherwise a JSONL scalar
log at ``<output_dir>/logs/metrics.jsonl`` and a GIF tree at
``<output_dir>/media/videos/step_<N>/<name>.gif``, with the JAX tracker's
keys and layout. Validation runs the port's pipelines, which hold their
modules' weights: a trainer puts the weights to validate (EMA, LoRA) into
the modules around the call. One ``torch.Generator`` on the pipeline's
device draws every sample's noise, where the JAX function splits keys.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..metrics.iou import binary_mask_iou
from ..utils.misc import wandb_available
from ..utils.samples import get_n_training_samples
from ..utils.video_io import export_to_video


class Tracker:
    """Scalar + media logger (W&B or local JSONL/GIF)."""

    def __init__(self, cfg, out_dir: Optional[str] = None):
        self.cfg = cfg
        out_dir = out_dir or cfg.output_dir
        self.media_root = os.path.join(out_dir, "media", "videos")
        self.scalar_path = os.path.join(out_dir, "logs", "metrics.jsonl")
        os.makedirs(os.path.dirname(self.scalar_path), exist_ok=True)
        self.use_wandb = cfg.report_to == "wandb" and wandb_available()
        self._t0 = time.time()
        if self.use_wandb:
            import wandb

            wandb.init(project=cfg.project_name, name=cfg.run_name,
                       config=dataclasses.asdict(cfg), dir=cfg.logging_dir)

    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        record = {k: float(v) for k, v in scalars.items()}
        record.update(step=int(step), wall_time=round(time.time() - self._t0, 3))
        with open(self.scalar_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self.use_wandb:
            import wandb

            wandb.log({k: v for k, v in record.items() if k != "step"}, step=int(step))

    def log_video(self, step: int, name: str, frames_uint8: np.ndarray, fps: int) -> str:
        """frames_uint8: (F, H, W, 3). Returns the exported path."""
        step_dir = os.path.join(self.media_root, f"step_{int(step)}")
        os.makedirs(step_dir, exist_ok=True)
        path = os.path.join(step_dir, f"{name}.gif")
        export_to_video(list(frames_uint8), path, fps=fps)
        if self.use_wandb:
            import wandb

            # wandb.Video wants (F, C, H, W)
            wandb.log({name.rsplit("_", 1)[0]: wandb.Video(frames_uint8.transpose(0, 3, 1, 2),
                                                           fps=fps)}, step=int(step))
        return path

    def finish(self) -> None:
        if self.use_wandb:
            import wandb

            wandb.finish()


def collect_demo_samples(loader, n: int) -> List[dict]:
    """The first n samples, cached once before the loop (the reference's
    ``demo_samples``)."""
    return get_n_training_samples(loader, n)


def _to_uint8(frames01: np.ndarray) -> np.ndarray:
    return (np.clip(np.asarray(frames01, np.float32), 0.0, 1.0) * 255).astype(np.uint8)


def run_validation(
    tracker: Tracker,
    step: int,
    pipeline,
    demo_samples: List[dict],
    cfg,
    generator: torch.Generator,
    predict_bbox: bool = False,
    controlnet: bool = False,
) -> Dict[str, float]:
    """The pipeline on each cached demo sample, its video and the sample's
    ground truth logged as media. Returns the scalars logged: ``val_miou``
    (the selection metric of the generated bbox video) for the bbox
    predictor, else none."""
    mious = []
    for i, sample in enumerate(demo_samples):
        image = torch.from_numpy(sample["image_init"])[None]
        kwargs = dict(
            num_frames=cfg.clip_length,
            num_inference_steps=cfg.num_inference_steps,
            min_guidance_scale=cfg.min_guidance_scale,
            max_guidance_scale=cfg.max_guidance_scale,
            fps=cfg.fps,
            noise_aug_strength=cfg.noise_aug_strength,
            decode_chunk_size=min(cfg.decode_chunk_size, cfg.clip_length),
        )
        if controlnet:
            frames = pipeline(image, torch.from_numpy(sample["bbox_img"])[None], generator,
                              control_condition_scale=cfg.conditioning_scale, **kwargs)[0]
        elif predict_bbox:
            frames = pipeline(image, torch.from_numpy(sample["bbox_img"])[None], generator,
                              num_cond_bbox_frames=cfg.num_cond_bbox_frames, **kwargs)[0]
        else:
            frames = pipeline(image, generator=generator, **kwargs)[0]
        gen_u8 = _to_uint8(frames.cpu().numpy())
        tracker.log_video(step, f"generated_videos_{i}", gen_u8, cfg.fps)
        tracker.log_video(step, f"gt_videos_{i}", sample["gt_clip_np"], cfg.fps)
        if "bbox_img_np" in sample:
            tracker.log_video(step, f"gt_bbox_frames_{i}", sample["bbox_img_np"], cfg.fps)
            if predict_bbox:
                miou, _, _ = binary_mask_iou(sample["bbox_img_np"], gen_u8)
                mious.append(float(miou))
    metrics = {}
    if mious:
        metrics["val_miou"] = float(np.mean(mious))
        tracker.log_scalars(step, metrics)
    return metrics


@torch.no_grad()
def run_vae_validation(tracker: Tracker, step: int, vae, demo_samples: List[dict],
                       cfg) -> Dict[str, float]:
    """Reconstruction validation of the VAE-decoder finetune: each demo clip
    encoded (the mode) and decoded, logged beside its ground truth; returns
    ``val_psnr``, the mean PSNR over [-1, 1]."""
    device = next(vae.parameters()).device
    psnrs = []
    for i, sample in enumerate(demo_samples):
        clip = torch.from_numpy(sample["gt_clip"]).to(device)  # (F, H, W, 3) in [-1, 1]
        recon = vae.decode(vae.encode(clip), clip.shape[0])
        recon = recon.float().clamp(-1.0, 1.0).cpu().numpy()
        gt = np.asarray(sample["gt_clip"], np.float32)
        mse = float(np.mean((recon - gt) ** 2))
        psnrs.append(10.0 * np.log10(4.0 / max(mse, 1e-12)))  # range [-1, 1]
        tracker.log_video(step, f"generated_videos_{i}", _to_uint8(recon / 2 + 0.5), cfg.fps)
        tracker.log_video(step, f"gt_videos_{i}", sample["gt_clip_np"], cfg.fps)
    metrics = {"val_psnr": float(np.mean(psnrs))}
    tracker.log_scalars(step, metrics)
    return metrics
