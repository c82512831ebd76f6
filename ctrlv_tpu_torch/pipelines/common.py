"""Pipeline machinery: the device a pipeline runs on, conditioning encoders,
latent preparation, CFG ramp, the chunked temporal decode.

Counterpart of ``ctrlv_tpu/pipelines/common.py`` without its TPU machinery
(packed params, frame sharding).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models.clip_vision import clip_preprocess


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    num_frames: int = 25
    num_inference_steps: int = 25
    min_guidance_scale: float = 1.0
    max_guidance_scale: float = 3.0
    fps: int = 7
    motion_bucket_id: int = 127
    noise_aug_strength: float = 0.02
    decode_chunk_size: Optional[int] = 8
    # Bound on the frames of one batched VAE decode call; None decodes all
    # full chunks in one call.
    max_decode_frames: Optional[int] = None
    num_cond_bbox_frames: int = 3  # stage-1 latent substitution
    control_condition_scale: float = 1.0  # stage-2 ControlNet scale

    @property
    def do_cfg(self) -> bool:
        return self.max_guidance_scale > 1.0


def resolve_device(device) -> torch.device:
    """The device a pipeline runs on. ``None`` means the card and raises
    where there is none: a pipeline never moves to the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the pipelines of ctrlv_tpu_torch run on the GPU unless "
                'constructed with device="cpu"'
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for device='cuda'")
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def check_generator(generator: Optional[torch.Generator], device: torch.device) -> None:
    if generator is None:
        return
    gdev = generator.device  # "cuda" without an index is the current card
    if gdev.type != device.type or None not in (gdev.index, device.index) and gdev != device:
        raise ValueError(
            f"the generator lives on {generator.device}, the pipeline on {device}: make it "
            f"with torch.Generator(device={str(device)!r})"
        )


def default_guidance(cfg: SamplingConfig, batch: int, device):
    """The config's (min, max) guidance ramp, one row per sample, (B, 2)."""
    row = torch.tensor(
        [[cfg.min_guidance_scale, cfg.max_guidance_scale]], dtype=torch.float32, device=device
    )
    return row.repeat(batch, 1)


def _with_negative(x, do_cfg: bool):
    """CFG negative = zeros, stacked before the positive."""
    return torch.cat([torch.zeros_like(x), x], dim=0) if do_cfg else x


def encode_clip_image(image_encoder, image, do_cfg: bool):
    """[-1, 1] (B, H, W, 3) -> (2B or B, 1, proj_dim) CLIP embeddings."""
    pixel = clip_preprocess(image, image_size=image_encoder.config.image_size)
    return _with_negative(image_encoder(pixel)[:, None, :], do_cfg)


def encode_vae_image(vae, image, noise, noise_aug_strength: float, do_cfg: bool):
    """First frame plus noise augmentation -> VAE mode latent (no
    scaling_factor, the SVD convention)."""
    return _with_negative(vae.encode(image + noise_aug_strength * noise), do_cfg)


def encode_vae_video(vae, frames, do_cfg: bool):
    """(B, F, H, W, 3) conditioning frames -> (2B or B, F, h, w, 4) mode latents."""
    b, f = frames.shape[:2]
    lat = vae.encode(frames.reshape((b * f,) + frames.shape[2:]))
    return _with_negative(lat.reshape((b, f) + lat.shape[1:]), do_cfg)


def get_add_time_ids(cfg: SamplingConfig, batch: int, do_cfg: bool, device=None):
    """(fps-1, motion_bucket_id, noise_aug) micro-conditioning rows."""
    row = torch.tensor(
        [[cfg.fps - 1, cfg.motion_bucket_id, cfg.noise_aug_strength]],
        dtype=torch.float32, device=device,
    )
    ids = row.repeat(batch, 1)
    return torch.cat([ids, ids], dim=0) if do_cfg else ids


def guidance_linspace(num_frames: int, minmax):
    """Per-frame CFG weight, (B, F, 1, 1, 1), ramping linearly from
    ``minmax[:, 0]`` to ``minmax[:, 1]`` over the frames of each sample."""
    ramp = torch.linspace(0.0, 1.0, num_frames, device=minmax.device)
    g = minmax[:, 0:1] + (minmax[:, 1:2] - minmax[:, 0:1]) * ramp[None]
    return g[..., None, None, None]


def decode_latents(vae, latents, scaling_factor: float, decode_chunk_size=None,
                   max_frames_per_call=None):
    """(B, F, h, w, 4) -> (B, F, H, W, 3) in [-1, 1], decoded in chunks.

    The temporal decoder mixes the frames of one chunk, so
    ``decode_chunk_size`` changes the result. By default all full chunks go
    through one batched call (the decoder takes its clip count from
    B*F // chunk), so the decode's peak memory grows with the frame count
    and not with the chunk size. ``max_frames_per_call`` bounds it: full
    chunks are decoded in serial groups of at most that many frames per clip,
    rounded down to whole chunks, at least one chunk a call. The remainder
    goes through its own call.
    """
    b, f = latents.shape[:2]
    latents = latents / scaling_factor
    chunk = decode_chunk_size or f
    n_full, rem = divmod(f, chunk)
    outs = []
    if n_full:
        per_call = n_full
        if max_frames_per_call:
            per_call = max(1, min(n_full, max_frames_per_call // chunk))
        for start in range(0, n_full, per_call):
            n = min(per_call, n_full - start)
            piece = latents[:, start * chunk : (start + n) * chunk]
            dec = vae.decode(piece.reshape((b * n * chunk,) + piece.shape[2:]), chunk)
            outs.append(dec.reshape((b, n * chunk) + dec.shape[1:]))
    if rem:
        piece = latents[:, n_full * chunk:]
        dec = vae.decode(piece.reshape((b * rem,) + piece.shape[2:]), rem)
        outs.append(dec.reshape((b, rem) + dec.shape[1:]))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def postprocess_frames(frames):
    """[-1, 1] -> [0, 1], clamped."""
    return torch.clamp(frames / 2.0 + 0.5, 0.0, 1.0)
