"""AutoencoderKLTemporalDecoder, SVD's VAE.

Counterpart of ``ctrlv_tpu/models/vae.py``: the SD 2D encoder (mid block
with single-head attention) producing mean || logvar, and the temporal
decoder whose ResBlocks are SpatioTemporalResBlocks ("learned" merge, no
temb) followed by a (3,1,1) temporal conv. ``encode`` returns the mode;
``decode`` takes the frame count explicitly, because the temporal convs
mix the frames of one clip.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn

from .layers import Attention, DownsampleVAE2D, GroupNorm, Upsample2D
from .resnet import ResnetBlock2D, SpatioTemporalResBlock


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = 0.18215

    @classmethod
    def tiny(cls) -> "VAEConfig":
        return cls(block_out_channels=(32, 32), layers_per_block=1)

    @property
    def spatial_scale(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


def _vae_attention(c: int, head_dim: int) -> Attention:
    return Attention(
        c, heads=c // head_dim, dim_head=head_dim, qkv_bias=True,
        residual_connection=True, norm_num_groups=32, eps=1e-6,
    )


def _attend(attn: Attention, x):
    """Apply a token attention to (B, C, H, W); returns it contiguous."""
    b, c, h, w = x.shape
    tokens = attn(x.permute(0, 2, 3, 1).reshape(b, h * w, c))
    return tokens.reshape(b, h, w, c).permute(0, 3, 1, 2).contiguous()


class DownEncoderBlock2D(nn.Module):
    def __init__(self, in_channels, out_channels, num_layers=2, add_downsample=True):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(in_channels if i == 0 else out_channels, out_channels, None, eps=1e-6)
             for i in range(num_layers)]
        )
        self.downsamplers = (
            nn.ModuleList([DownsampleVAE2D(out_channels, out_channels)])
            if add_downsample else None
        )

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x


class UNetMidBlock2D(nn.Module):
    """Encoder mid block: resnet, single-head attention (residual), resnet."""

    def __init__(self, in_channels):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(in_channels, in_channels, None, eps=1e-6) for _ in range(2)]
        )
        self.attentions = nn.ModuleList([_vae_attention(in_channels, in_channels)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = _attend(self.attentions[0], x)
        return self.resnets[1](x)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        blocks = []
        out_ch = chans[0]
        for i, ch in enumerate(chans):
            in_ch, out_ch = out_ch, ch
            blocks.append(
                DownEncoderBlock2D(in_ch, out_ch, cfg.layers_per_block, i != len(chans) - 1)
            )
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = UNetMidBlock2D(out_ch)
        self.conv_norm_out = GroupNorm(32, out_ch, 1e-6, act="silu")
        self.conv_out = nn.Conv2d(out_ch, 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(self.conv_norm_out(x))


def _st_resnet(cin, cout) -> SpatioTemporalResBlock:
    return SpatioTemporalResBlock(
        cin, cout, None, eps=1e-6, merge_factor=0.0, merge_strategy="learned"
    )


class MidBlockTemporalDecoder(nn.Module):
    def __init__(self, in_channels, attention_head_dim=512):
        super().__init__()
        self.resnets = nn.ModuleList([_st_resnet(in_channels, in_channels) for _ in range(2)])
        self.attentions = nn.ModuleList([_vae_attention(in_channels, attention_head_dim)])

    def forward(self, x, image_only_indicator):
        x = self.resnets[0](x, None, image_only_indicator)
        x = _attend(self.attentions[0], x)
        return self.resnets[1](x, None, image_only_indicator)


class UpBlockTemporalDecoder(nn.Module):
    def __init__(self, in_channels, out_channels, num_layers=3, add_upsample=True):
        super().__init__()
        self.resnets = nn.ModuleList(
            [_st_resnet(in_channels if i == 0 else out_channels, out_channels)
             for i in range(num_layers)]
        )
        self.upsamplers = (
            nn.ModuleList([Upsample2D(out_channels, out_channels)]) if add_upsample else None
        )

    def forward(self, x, image_only_indicator):
        for resnet in self.resnets:
            x = resnet(x, None, image_only_indicator)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class TemporalDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.latent_channels, chans[-1], 3, padding=1)
        self.mid_block = MidBlockTemporalDecoder(chans[-1], attention_head_dim=chans[-1])
        rev = tuple(reversed(chans))
        blocks = []
        ch = rev[0]
        for i, out_ch in enumerate(rev):
            blocks.append(
                UpBlockTemporalDecoder(ch, out_ch, cfg.layers_per_block + 1, i != len(rev) - 1)
            )
            ch = out_ch
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = GroupNorm(32, chans[0], 1e-6, act="silu")
        self.conv_out = nn.Conv2d(chans[0], cfg.out_channels, 3, padding=1)
        self.time_conv_out = nn.Conv3d(
            cfg.out_channels, cfg.out_channels, (3, 1, 1), padding=(1, 0, 0)
        )

    def forward(self, z, num_frames: int):
        """z (B*F, 4, h, w) -> (B*F, 3, H, W)."""
        bf = z.shape[0]
        batch = bf // num_frames
        image_only_indicator = torch.zeros(batch, num_frames, dtype=z.dtype, device=z.device)
        x = self.mid_block(self.conv_in(z), image_only_indicator)
        for block in self.up_blocks:
            x = block(x, image_only_indicator)
        x = self.conv_out(self.conv_norm_out(x))
        _, c, h, w = x.shape
        xt = x.reshape(batch, num_frames, c, h, w).permute(0, 2, 1, 3, 4)
        xt = self.time_conv_out(xt)
        return xt.permute(0, 2, 1, 3, 4).reshape(bf, c, h, w)


class AutoencoderKLTemporalDecoder(nn.Module):
    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1)
        self.decoder = TemporalDecoder(config)

    @property
    def dtype(self):
        return self.quant_conv.weight.dtype

    def encode(self, x):
        """(B, H, W, 3) -> mode latents (B, h, w, 4), without scaling_factor."""
        # contiguous NCHW: a permuted view would make the convs answer channels-last
        moments = self.quant_conv(self.encoder(x.to(self.dtype).permute(0, 3, 1, 2).contiguous()))
        mean = moments[:, : self.config.latent_channels]
        return mean.permute(0, 2, 3, 1)

    def decode(self, z, num_frames: int = 1):
        """(B*F, h, w, 4) -> (B*F, H, W, 3)."""
        out = self.decoder(z.to(self.dtype).permute(0, 3, 1, 2).contiguous(), num_frames)
        return out.permute(0, 2, 3, 1)
