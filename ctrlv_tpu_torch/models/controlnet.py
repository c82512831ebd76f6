"""Spatio-temporal ControlNet for Box2Video.

Counterpart of ``ctrlv_tpu/models/controlnet.py``: the UNet's down and mid
topology, a ``control_conv_in`` over the 4-channel conditioning latents
whose output is added to ``conv_in``'s, and one 1x1 "zero" conv per down
residual plus one for the mid block, scaled by ``conditioning_scale``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import TimestepEmbedding
from .unet_st import (
    UNetSTConfig,
    embed_time,
    flatten_frames,
    make_down_blocks,
    make_mid_block,
    run_down_blocks,
    to_frames_nchw,
)


def down_residual_channels(cfg: UNetSTConfig) -> list:
    """Channels of the down residuals: conv_in, each layer, each downsampler."""
    chans = [cfg.block_out_channels[0]]
    for i, ch in enumerate(cfg.block_out_channels):
        chans += [ch] * cfg.layers_per_block
        if i != len(cfg.block_out_channels) - 1:
            chans.append(ch)
    return chans


class ControlNetSpatioTemporal(nn.Module):
    def __init__(self, config: UNetSTConfig = UNetSTConfig(), temporal_layout: str = "seq"):
        super().__init__()
        cfg = self.config = config
        c0 = cfg.block_out_channels[0]
        self.conv_in = nn.Conv2d(cfg.in_channels, c0, 3, padding=1)
        self.control_conv_in = nn.Conv2d(cfg.in_channels // 2, c0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(c0, c0 * 4)
        self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim, c0 * 4)
        self.down_blocks = make_down_blocks(cfg, temporal_layout)
        self.mid_block = make_mid_block(cfg, temporal_layout)
        self.controlnet_down_blocks = nn.ModuleList(
            [nn.Conv2d(c, c, 1) for c in down_residual_channels(cfg)]
        )
        c_mid = cfg.block_out_channels[-1]
        self.controlnet_mid_block = nn.Conv2d(c_mid, c_mid, 1)
        for conv in [*self.controlnet_down_blocks, self.controlnet_mid_block]:
            nn.init.zeros_(conv.weight)
            nn.init.zeros_(conv.bias)

    def forward(
        self,
        sample,  # (B, F, H, W, C_in)
        timestep,
        encoder_hidden_states,  # (B, 1, cross_dim)
        added_time_ids,  # (B, 3)
        control_cond,  # (B, F, H, W, C_in // 2) conditioning latents
        conditioning_scale: float = 1.0,
    ):
        """Returns (down residuals, mid residual), each (B*F, C, h, w): the
        UNet of this package takes them as they are."""
        dtype = self.conv_in.weight.dtype
        batch = sample.shape[0]
        emb = embed_time(self, timestep, added_time_ids, batch, dtype)
        sample, emb, encoder_hidden_states, image_only_indicator = flatten_frames(
            sample, emb, encoder_hidden_states, dtype
        )
        sample = self.conv_in(sample) + self.control_conv_in(to_frames_nchw(control_cond, dtype))
        sample, down_res = run_down_blocks(
            self.down_blocks, sample, emb, encoder_hidden_states, image_only_indicator
        )
        sample = self.mid_block(sample, emb, encoder_hidden_states, image_only_indicator)

        ctrl_res = tuple(
            conv(res) * conditioning_scale
            for conv, res in zip(self.controlnet_down_blocks, down_res)
        )
        return ctrl_res, self.controlnet_mid_block(sample) * conditioning_scale


@torch.no_grad()
def controlnet_from_unet(unet: nn.Module, controlnet: ControlNetSpatioTemporal) -> int:
    """Copy every UNet weight whose name and shape the ControlNet shares
    (conv_in, embeddings, down and mid blocks), leaving control_conv_in and
    the zero convs as they are. Returns the number of tensors copied."""
    src = unet.state_dict()
    copied = 0
    for name, dst in controlnet.state_dict().items():
        if name in src and src[name].shape == dst.shape:
            dst.copy_(src[name])
            copied += 1
    if copied == 0:
        raise ValueError("controlnet_from_unet copied nothing: parameter names differ")
    return copied
