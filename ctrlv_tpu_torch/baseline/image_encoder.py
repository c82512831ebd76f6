"""Image-context encoder of the AR baseline ("map embedding").

Counterpart of ``ctrlv_tpu/baseline/image_encoder.py``: the frozen VAE and
CLIP of the initial frame; the CLIP image embedding goes through an MLP to
one context token, the VAE latent through conv + adaptive max-pool stacks
whose channels become 32 tokens of hidden_dim; the tokens join the
encoder's memory.

The JAX projector is NHWC and infers its input widths; this one takes the
VAE latent NHWC (as the port's ``vae.encode`` returns it), convolves in
NCHW, and is told the CLIP embedding's width and the latent's channels.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.clip_vision import clip_preprocess
from .config import BaselineConfig


class ImageContextProjector(nn.Module):
    """Trainable projections over the frozen VAE and CLIP features."""

    def __init__(self, cfg: BaselineConfig, clip_dim: int, latent_channels: int = 4,
                 out_tokens_channels: int = 32, pool_size: int = 16):
        super().__init__()
        hidden = cfg.hidden_dim
        self.out_tokens_channels, self.pool_size = out_tokens_channels, pool_size
        self.clip_fc1 = nn.Linear(clip_dim, hidden)
        self.clip_fc2 = nn.Linear(hidden, hidden)
        self.conv1 = nn.Conv2d(latent_channels, out_tokens_channels // 2, 3, padding=1)
        self.conv2 = nn.Conv2d(out_tokens_channels // 2, out_tokens_channels, 3, padding=1)
        self.vae_fc1 = nn.Linear(pool_size * pool_size, hidden)
        self.vae_fc2 = nn.Linear(hidden, hidden)

    def forward(self, clip_embed: torch.Tensor, vae_latent: torch.Tensor) -> torch.Tensor:
        """clip_embed (B, D_clip); vae_latent (B, h, w, C) ->
        (B, 1 + out_tokens_channels, hidden)."""
        c = self.clip_fc2(F.relu(self.clip_fc1(clip_embed)))[:, None, :]
        v = F.relu(self.conv1(vae_latent.permute(0, 3, 1, 2).contiguous()))
        v = adaptive_max_pool(v, self.pool_size * 2)
        v = F.relu(self.conv2(v))
        v = adaptive_max_pool(v, self.pool_size)
        # (B, C, pool, pool) -> (B, C, pool^2): channels become tokens
        v = v.reshape(v.shape[0], self.out_tokens_channels, self.pool_size * self.pool_size)
        v = self.vae_fc2(F.relu(self.vae_fc1(v)))
        return torch.cat([c, v], dim=1)


def _nearest_index(size: int, out: int, device) -> torch.Tensor:
    """jax.image.resize's "nearest" source rows: floor((i + 0.5) * size / out) in f32."""
    pos = (torch.arange(out, dtype=torch.float32, device=device) + 0.5) * size / out
    return torch.floor(pos).long()


def adaptive_max_pool(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """The JAX package's AdaptiveMaxPool2d on (B, C, H, W): a side below
    ``out_size`` is first resized up by nearest neighbour; then the largest
    whole windows of (H // out, W // out), the remainder rows and columns
    cropped."""
    b, c, h, w = x.shape
    if h < out_size or w < out_size:
        hh, ww = max(h, out_size), max(w, out_size)
        if hh != h:
            x = x[:, :, _nearest_index(h, hh, x.device)]
        if ww != w:
            x = x[:, :, :, _nearest_index(w, ww, x.device)]
        h, w = hh, ww
    kh, kw = h // out_size, w // out_size
    x = x[:, :, : kh * out_size, : kw * out_size]
    return x.reshape(b, c, out_size, kh, out_size, kw).amax(dim=(3, 5))


class ImageEncoder:
    """Frozen VAE and CLIP feature extraction, then the trainable projector
    (on the VAE's device, in f32)."""

    def __init__(self, cfg: BaselineConfig, vae, clip):
        self.cfg = cfg
        self.vae = vae
        self.clip = clip
        self.projector = ImageContextProjector(
            cfg, clip.config.projection_dim, vae.config.latent_channels
        ).to(next(vae.parameters()).device)

    @torch.no_grad()
    def features(self, images: torch.Tensor):
        """images (B, H, W, 3) in [-1, 1] -> frozen (clip_embed, vae_latent)."""
        pixel = clip_preprocess(images.float(), image_size=self.clip.config.image_size)
        return self.clip(pixel), self.vae.encode(images)

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        clip_e, vae_l = self.features(images)
        dtype = self.projector.clip_fc1.weight.dtype
        return self.projector(clip_e.to(dtype), vae_l.to(dtype))
