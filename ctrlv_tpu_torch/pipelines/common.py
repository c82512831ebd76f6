"""Pipeline machinery: the device a pipeline runs on, conditioning encoders,
latent preparation, CFG ramp, the chunked temporal decode, and where a
sampler's latents lie on a mesh (``SampleShard``).

Counterpart of ``ctrlv_tpu/pipelines/common.py`` without its TPU machinery
(packed params).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models.clip_vision import clip_preprocess
from ..parallel.frames import FrameShard
from ..parallel.mesh import AXES
from ..parallel.sharding import gather_shares, shares


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


class SampleShard:
    """Where a sampler's (B, F, ...) latents lie on a mesh: the counterpart of
    the JAX package's ``maybe_shard_frames``. On a mesh over a process group
    the B samples (before the CFG doubling) split over the data axis and the
    F frames over the frame axis, both contiguously and possibly unevenly
    (25 frames over 2 ranks are 13 + 12, the overall eval's 5 candidates 3 +
    2); one sample is not split, as in the JAX package. Without a mesh, or
    on the mesh of a lone process, the rank holds everything and every
    method is the identity. The conditioning is computed whole on every rank
    and cut with ``local``; the denoised latents are made whole again with
    ``gather``, so that every rank decodes and returns the same output."""

    def __init__(self, mesh, batch: int, frames: int, do_cfg: bool):
        self.batch, self.do_cfg = batch, do_cfg
        self.mesh = mesh if mesh is not None and mesh.device_mesh is not None else None
        self.row_bounds = None
        self.lo, self.hi = 0, batch
        self.frame = None
        if self.mesh is not None:
            if batch > 1:
                self.row_bounds = shares(batch, self.mesh.n_data)
                self.lo, self.hi = self.row_bounds[self.mesh.index(AXES.data)]
            self.frame = FrameShard(self.mesh, frames)

    @property
    def rows(self) -> int:
        return self.hi - self.lo

    def local(self, x, cfg: bool = False, frames: bool = True):
        """This rank's part of (B, ...) or, with ``cfg``, of a CFG-doubled
        (2B, ...) tensor (its negative rows, then its positive ones); with
        ``frames`` axis 1 is the frame axis and is cut too."""
        if self.mesh is None:
            return x
        if cfg and self.do_cfg:
            x = torch.cat([x[self.lo:self.hi], x[self.batch + self.lo:self.batch + self.hi]])
        else:
            x = x[self.lo:self.hi]
        return self.frame.local_frames(x).contiguous() if frames else x.contiguous()

    def gather(self, latents):
        """This rank's (b, f, ...) latents -> the whole (B, F, ...) on every rank."""
        if self.mesh is None:
            return latents
        b, f = latents.shape[:2]
        rest = latents.shape[2:]
        full = self.frame.gather(latents.reshape((b * f,) + rest), b)
        full = full.reshape((b, self.frame.frames) + rest)
        if self.row_bounds is not None:
            full = gather_shares(full, self.mesh, AXES.data, self.row_bounds, dim=0)
        return full
