"""Overall two-stage pipeline: five bbox-video candidates, select, Box2Video.

Counterpart of ``ctrlv_tpu/pipelines/overall.py``:

- five bbox-video candidates per input, with guidance (min, max) in
  ``GUIDANCE_PAIRS``, as ONE batched stage-1 call (the per-sample guidance
  ramps are a (5, 2) tensor);
- darkness cleanup: pixels whose channel sum is below 50/255 are zeroed, and
  interior frames whose every pixel is bright are zeroed entirely;
- the best candidate by clip mask IoU against the ground-truth bbox frames,
  both quantised to uint8 steps, scored on the device; of equal scores the
  later candidate wins;
- Box2Video on the winner, conditioned on the raw stage-1 output (the
  cleanup feeds only the selection and the exported bbox video).

One generator serves both stages in a fixed order: stage 1's image noise and
latents, then stage 2's. The draws of either stage can be handed in instead.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..metrics.iou import binary_mask_iou, binary_mask_iou_batch
from .video_control import StableVideoControlPipeline
from .video_diffusion import VideoDiffusionPipeline

GUIDANCE_PAIRS = ((1.0, 2.0), (1.0, 3.0), (2.0, 4.0), (2.0, 5.0), (3.0, 5.0))


def darkness_cleanup(frames, threshold: float = 50.0 / 255.0):
    """Zero near-black pixels; zero interior frames that are entirely bright.

    frames: (N, F, H, W, 3) in [0, 1].
    """
    zero = torch.zeros((), dtype=frames.dtype, device=frames.device)
    channel_sum = frames.sum(dim=-1, keepdim=True)
    frames = torch.where(channel_sum < threshold, zero, frames)
    # an interior frame whose least channel sum is above the threshold is broken
    min_sum = frames.sum(dim=-1).amin(dim=(-2, -1))  # (N, F)
    idx = torch.arange(frames.shape[1], device=frames.device)
    interior = (idx > 0) & (idx < frames.shape[1] - 1)
    kill = (min_sum > threshold) & interior[None, :]
    return torch.where(kill[:, :, None, None, None], zero, frames)


class OverallPipeline:
    def __init__(self, bbox_pipeline: VideoDiffusionPipeline,
                 ctrl_pipeline: StableVideoControlPipeline):
        if bbox_pipeline.device != ctrl_pipeline.device:
            raise ValueError(
                f"the two stages live on {bbox_pipeline.device} and {ctrl_pipeline.device}"
            )
        self.bbox_pipeline = bbox_pipeline
        self.ctrl_pipeline = ctrl_pipeline
        self.device = bbox_pipeline.device

    @torch.no_grad()
    def __call__(
        self,
        image,  # (H, W, 3) in [-1, 1], one sample
        bbox_images,  # (F, H, W, 3) ground-truth bbox frames in [-1, 1]
        generator: Optional[torch.Generator] = None,
        num_frames: int = 25,
        stage1_steps: int = 30,
        stage2_steps: int = 25,
        fps: int = 7,
        noise_aug_strength: float = 0.02,
        num_cond_bbox_frames: int = 3,
        min_guidance_scale: float = 1.0,
        max_guidance_scale: float = 3.0,
        control_condition_scale: float = 1.0,
        decode_chunk_size: int = 8,
        max_decode_frames: Optional[int] = None,
        stage1_noise=None,  # (image_noise (5,H,W,3), latents (5,F,h,w,4)); drawn if None
        stage2_noise=None,  # (image_noise (1,H,W,3), latents (1,F,h,w,4)); drawn if None
    ) -> Dict[str, object]:
        """The video (F, H, W, 3) and the cleaned winning bbox video, both
        numpy in [0, 1], the winner's scores and its guidance pair."""
        n = len(GUIDANCE_PAIRS)
        image, bbox_images = image.to(self.device), bbox_images.to(self.device)
        noise1, latents1 = stage1_noise if stage1_noise is not None else (None, None)
        noise2, latents2 = stage2_noise if stage2_noise is not None else (None, None)

        # Stage 1: all five guidance pairs as one batch.
        candidates = self.bbox_pipeline(
            image[None].repeat(n, 1, 1, 1),
            bbox_images=bbox_images[None].repeat(n, 1, 1, 1, 1),
            generator=generator,
            guidance_minmax=torch.tensor(GUIDANCE_PAIRS, dtype=torch.float32),
            image_noise=noise1,
            latents=latents1,
            num_frames=num_frames,
            num_inference_steps=stage1_steps,
            fps=fps,
            noise_aug_strength=noise_aug_strength,
            num_cond_bbox_frames=num_cond_bbox_frames,
            decode_chunk_size=decode_chunk_size,
            max_decode_frames=max_decode_frames,
        )  # (5, F, H, W, 3) in [0, 1]

        cleaned = darkness_cleanup(candidates)
        gt01 = torch.clamp(bbox_images / 2.0 + 0.5, 0.0, 1.0)
        # Both sides in uint8 steps, as the reference's *255 and uint8 cast.
        gt_u8 = torch.floor(gt01 * 255.0)
        cand_u8 = torch.floor(cleaned * 255.0)
        scores = binary_mask_iou_batch(gt_u8, cand_u8).cpu()  # (5, 3): iou, precision, recall
        # of equal scores the later candidate wins
        best = n - 1 - int(torch.argmax(scores.flip(0)[:, 0]))

        first_last = [0, num_frames - 1]
        miou_fl = binary_mask_iou(
            gt_u8[first_last].cpu().numpy(), cand_u8[best][first_last].cpu().numpy()
        )

        # Stage 2: Box2Video on the winner's raw frames.
        frames = self.ctrl_pipeline(
            image[None],
            (2.0 * (candidates[best] - 0.5))[None],
            generator=generator,
            image_noise=noise2,
            latents=latents2,
            num_frames=num_frames,
            num_inference_steps=stage2_steps,
            min_guidance_scale=min_guidance_scale,
            max_guidance_scale=max_guidance_scale,
            fps=fps,
            noise_aug_strength=noise_aug_strength,
            control_condition_scale=control_condition_scale,
            decode_chunk_size=decode_chunk_size,
            max_decode_frames=max_decode_frames,
        )[0]

        iou, precision, recall = (float(x) for x in scores[best])
        return dict(
            video=frames.cpu().numpy(),
            bbox_video=cleaned[best].cpu().numpy(),
            miou=iou,
            ap=precision,
            ar=recall,
            miou_first_last=miou_fl[0],
            ap_first_last=miou_fl[1],
            ar_first_last=miou_fl[2],
            best_guidance=GUIDANCE_PAIRS[best],
        )
