"""ResNet blocks: spatial 2D, temporal (3,1,1)-conv, and the blended ST block.

Counterpart of ``ctrlv_tpu/models/resnet.py``. Spatial blocks take
(B*F, C, H, W); the temporal block takes (B, C, F, H, W).

A same-channel ``ResnetBlock2D`` with a time embedding routes to the fused
kernel of ``ops/resblock.py`` where ``set_fused_resblock`` and the shape gate
allow; ``plain_kernels()`` sends it to that kernel's plain version.

Under a frame shard (``parallel/frames.py``) the ST block's temporal half
gathers the frames of its input over the frame group and keeps its own.
"""

from __future__ import annotations

from typing import Optional

import torch.nn as nn
import torch.nn.functional as F

from ..ops._launch import plain_selected
from ..parallel.frames import current_frame_shard
from ..ops.resblock import fused_resblock2d, fused_resblock2d_plain, resblock_supported
from .layers import AlphaBlender, GroupNorm


class ResnetBlock2D(nn.Module):
    """GN-SiLU-Conv twice (the SiLU fused into the norm), time-embedding
    injection, 1x1 shortcut."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        temb_channels: Optional[int] = 1280,
        eps: float = 1e-6,
    ):
        super().__init__()
        self.norm1 = GroupNorm(32, in_channels, eps, act="silu")
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = (
            nn.Linear(temb_channels, out_channels) if temb_channels is not None else None
        )
        self.norm2 = GroupNorm(32, out_channels, eps, act="silu")
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (
            nn.Conv2d(in_channels, out_channels, 1) if in_channels != out_channels else None
        )

    def forward(self, x, temb=None):
        if (self.conv_shortcut is None and temb is not None and self.time_emb_proj is not None
                and resblock_supported(*x.shape, self.norm1.num_groups, x.dtype)):
            fn = fused_resblock2d_plain if plain_selected() else fused_resblock2d
            return fn(
                x, self.norm1.weight, self.norm1.bias, self.conv1.weight, self.conv1.bias,
                self.time_emb_proj(F.silu(temb)), self.norm2.weight, self.norm2.bias,
                self.conv2.weight, self.conv2.bias, self.norm1.num_groups, self.norm1.eps,
            )
        h = self.conv1(self.norm1(x))
        if temb is not None and self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        residual = self.conv_shortcut(x) if self.conv_shortcut is not None else x
        return h + residual


class TemporalResnetBlock(nn.Module):
    """ResNet block with (3,1,1) temporal convs over (B, C, F, H, W)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        temb_channels: Optional[int] = 1280,
        eps: float = 1e-6,
    ):
        super().__init__()
        self.norm1 = GroupNorm(32, in_channels, eps, act="silu")
        self.conv1 = nn.Conv3d(in_channels, out_channels, (3, 1, 1), padding=(1, 0, 0))
        self.time_emb_proj = (
            nn.Linear(temb_channels, out_channels) if temb_channels is not None else None
        )
        self.norm2 = GroupNorm(32, out_channels, eps, act="silu")
        self.conv2 = nn.Conv3d(out_channels, out_channels, (3, 1, 1), padding=(1, 0, 0))
        self.conv_shortcut = (
            nn.Conv3d(in_channels, out_channels, 1) if in_channels != out_channels else None
        )

    def forward(self, x, temb=None):
        # x: (B, C, F, H, W); temb: (B, F, temb_channels)
        h = self.conv1(self.norm1(x))
        if temb is not None and self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb)).transpose(1, 2)[:, :, :, None, None]
        h = self.conv2(self.norm2(h))
        residual = self.conv_shortcut(x) if self.conv_shortcut is not None else x
        return h + residual


class SpatioTemporalResBlock(nn.Module):
    """Spatial ResBlock, then a temporal ResBlock, blended by a learned alpha.

    Input and output (B*F, C, H, W); the frame count comes from
    image_only_indicator's last axis, as in the JAX package.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        temb_channels: Optional[int] = 1280,
        eps: float = 1e-6,
        merge_factor: float = 0.5,
        merge_strategy: str = "learned_with_images",
    ):
        super().__init__()
        self.spatial_res_block = ResnetBlock2D(in_channels, out_channels, temb_channels, eps=eps)
        self.temporal_res_block = TemporalResnetBlock(
            out_channels, out_channels, temb_channels, eps=eps
        )
        self.time_mixer = AlphaBlender(
            merge_factor, merge_strategy, switch_spatial_to_temporal_mix=True
        )

    def forward(self, hidden_states, temb=None, image_only_indicator=None):
        num_frames = image_only_indicator.shape[-1]
        x = self.spatial_res_block(hidden_states, temb)
        shard = current_frame_shard()
        xs, ts = x, temb
        if shard is not None:
            # the temporal half (its GroupNorm and its convs) spans every frame
            batch = image_only_indicator.shape[0]
            xs = shard.gather(x, batch)
            ts = None if temb is None else shard.gather(temb, batch)
        bf, c, h, w = xs.shape
        b = bf // num_frames
        # contiguous: the norm kernel and the temporal conv read (B, C, F, H, W)
        x5 = xs.reshape(b, num_frames, c, h, w).permute(0, 2, 1, 3, 4).contiguous()
        temb_f = ts.reshape(b, num_frames, -1) if ts is not None else None
        xt = self.temporal_res_block(x5, temb_f)
        xt = xt.permute(0, 2, 1, 3, 4).reshape(bf, c, h, w)
        if shard is not None:
            xt = shard.take(xt, b)
            image_only_indicator = shard.local_frames(image_only_indicator)
        return self.time_mixer(x, xt, image_only_indicator)
