"""Plain SVD generation (no bbox conditioning): the FVD baselines.

    python -m ctrlv_tpu_torch.tools.eval_video_generation --dataset_name synthetic --device cpu ...

Counterpart of ``tools/eval_video_generation.py`` (the reference's tool of
the same name). For each test clip: unconditioned image-to-video from its
first frame, the generated and the ground-truth videos exported as
``generated_videos_{i}.gif`` and ``gt_videos_{i}.gif`` (the pairs
``metrics.offline_eval`` reads); with ``compute_fvd=True``, FVD over the
(ground truth, generated) pairs at the end, with the I3D on the same device
(seeded random weights: a smoke value).

As in the JAX tool, the synthetic dataset means the tiny models,
``--num_demo_samples`` bounds the clips and ``compute_fvd`` is a keyword of
``main``, not a flag. One ``torch.Generator`` on the device, seeded with
``--seed``, draws every clip's noise. The tool runs on the card unless
``--device`` says otherwise.
"""

from __future__ import annotations

import os
import time

import torch

from ..data import get_dataloader
from ..metrics.fvd import FVD
from ..pipelines import VideoDiffusionPipeline
from ..utils.config import Config, parse_args
from ..utils.video_io import export_to_video, frames_to_uint8
from .common import build_models


def make_pipeline(models) -> VideoDiffusionPipeline:
    return VideoDiffusionPipeline(models["unet"], models["vae"], models["clip"],
                                  device=models["device"])


def evaluate(pipe, loader, cfg: Config, max_samples=None, export: bool = True,
             compute_fvd: bool = False):
    """Run the loop over ``loader``; returns (summary, samples): the summary
    holds the FVD where ``compute_fvd``, and each sample's record the
    pipeline's seconds, the seconds the loop waited on the loader for it,
    the export's seconds and the I3D's (its features of the pair)."""
    if export:
        os.makedirs(cfg.output_dir, exist_ok=True)
    generator = torch.Generator(device=pipe.device).manual_seed(cfg.seed)
    fvd = FVD(device=pipe.device) if compute_fvd else None
    limit = max_samples or cfg.num_demo_samples
    samples = []
    batches = iter(loader)
    for i in range(len(loader)):
        if limit and i >= limit:
            break
        t0 = time.perf_counter()
        batch = next(batches)
        t1 = time.perf_counter()
        gen = pipe(
            batch["clips"][:, 0], generator=generator,
            num_frames=cfg.clip_length,
            num_inference_steps=cfg.num_inference_steps,
            min_guidance_scale=cfg.min_guidance_scale,
            max_guidance_scale=cfg.max_guidance_scale,
            fps=cfg.fps,
            noise_aug_strength=cfg.noise_aug_strength,
            decode_chunk_size=cfg.decode_chunk_size,
        )[0].float()
        gt = torch.clamp(batch["clips"][0].to(gen.device) / 2 + 0.5, 0, 1)
        if gen.device.type == "cuda":
            torch.cuda.synchronize(gen.device)
        t2 = time.perf_counter()
        if export:
            export_to_video(frames_to_uint8(gen.cpu().numpy()),
                            os.path.join(cfg.output_dir, f"generated_videos_{i}.gif"), fps=cfg.fps)
            export_to_video(frames_to_uint8(gt.cpu().numpy()),
                            os.path.join(cfg.output_dir, f"gt_videos_{i}.gif"), fps=cfg.fps)
        t3 = time.perf_counter()
        if fvd is not None:
            fvd.update(gt[None], gen[None])
        t4 = time.perf_counter()
        print(f"[{i}] generated ({t2 - t1:.3f} s, loader wait {t1 - t0:.3f} s, export "
              f"{t3 - t2:.3f} s)", flush=True)
        samples.append(dict(seconds=t2 - t1, loader_wait_seconds=t1 - t0,
                            export_seconds=t3 - t2, fvd_seconds=t4 - t3))
    summary = {}
    if fvd is not None:
        summary["fvd"] = fvd.compute()
        print("FVD:", summary["fvd"])
    return summary, samples


def main(cfg=None, max_samples=None, compute_fvd=False):
    """The FVD where ``compute_fvd``, else None, as the JAX tool returns."""
    cfg = cfg or parse_args()
    tiny = cfg.dataset_name == "synthetic"
    models = build_models(cfg, tiny=tiny)
    _, loader = get_dataloader(
        cfg.data_root, cfg.dataset_name, if_train=False, batch_size=1,
        num_workers=cfg.dataloader_num_workers,
        clip_length=cfg.clip_length, shuffle=False, if_return_bbox_im=False,
        train_H=cfg.train_H, train_W=cfg.train_W, pin_memory=models["device"].type == "cuda",
    )
    summary, _ = evaluate(make_pipeline(models), loader, cfg, max_samples=max_samples,
                          compute_fvd=compute_fvd)
    return summary.get("fvd")


if __name__ == "__main__":
    main()
