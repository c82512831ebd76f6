"""SVD UNet down, mid and up spatio-temporal blocks.

Counterpart of ``ctrlv_tpu/models/blocks_st.py``: two layers per down
block, three per up block, resnet eps 1e-5, one transformer layer per
attention. Activations are (B*F, C, H, W).

``remat_sub=True`` checkpoints each ResBlock and each transformer on its own
while a gradient is being recorded (the JAX package's ``nn.remat`` per
sub-module): its activations are dropped after the forward and recomputed
in the backward pass.
"""

from __future__ import annotations

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from .layers import Downsample2D, Upsample2D
from .resnet import SpatioTemporalResBlock
from .transformer_st import TransformerSpatioTemporalModel


def maybe_checkpoint(on: bool, module, *args):
    """``module(*args)``, checkpointed when ``on`` and a gradient is being
    recorded. The modules draw no random numbers, so no generator state is
    kept for the re-run."""
    if on and torch.is_grad_enabled():
        return checkpoint(module, *args, use_reentrant=False, preserve_rng_state=False)
    return module(*args)


def _resnet(cin: int, cout: int, temb_channels: int) -> SpatioTemporalResBlock:
    return SpatioTemporalResBlock(cin, cout, temb_channels, eps=1e-5)


def _transformer(channels, heads, layers, cross_dim, temporal_layout) -> TransformerSpatioTemporalModel:
    return TransformerSpatioTemporalModel(
        heads, channels // heads, channels, layers, cross_dim, temporal_layout=temporal_layout
    )


class DownBlockSpatioTemporal(nn.Module):
    def __init__(self, in_channels, out_channels, num_layers=2, add_downsample=True,
                 temb_channels=1280, remat_sub=False):
        super().__init__()
        self.remat_sub = remat_sub
        self.resnets = nn.ModuleList(
            [_resnet(in_channels if i == 0 else out_channels, out_channels, temb_channels)
             for i in range(num_layers)]
        )
        self.downsamplers = (
            nn.ModuleList([Downsample2D(out_channels, out_channels)]) if add_downsample else None
        )

    def forward(self, hidden_states, temb, image_only_indicator):
        output_states = ()
        for resnet in self.resnets:
            hidden_states = maybe_checkpoint(
                self.remat_sub, resnet, hidden_states, temb, image_only_indicator)
            output_states += (hidden_states,)
        if self.downsamplers is not None:
            hidden_states = self.downsamplers[0](hidden_states)
            output_states += (hidden_states,)
        return hidden_states, output_states


class CrossAttnDownBlockSpatioTemporal(nn.Module):
    def __init__(
        self,
        in_channels,
        out_channels,
        num_layers=2,
        transformer_layers_per_block=1,
        num_attention_heads=1,
        cross_attention_dim=1024,
        add_downsample=True,
        temb_channels=1280,
        temporal_layout="seq",
        remat_sub=False,
    ):
        super().__init__()
        self.remat_sub = remat_sub
        self.resnets = nn.ModuleList(
            [_resnet(in_channels if i == 0 else out_channels, out_channels, temb_channels)
             for i in range(num_layers)]
        )
        self.attentions = nn.ModuleList(
            [_transformer(out_channels, num_attention_heads, transformer_layers_per_block,
                          cross_attention_dim, temporal_layout)
             for _ in range(num_layers)]
        )
        self.downsamplers = (
            nn.ModuleList([Downsample2D(out_channels, out_channels)]) if add_downsample else None
        )

    def forward(self, hidden_states, temb, encoder_hidden_states, image_only_indicator):
        output_states = ()
        for resnet, attn in zip(self.resnets, self.attentions):
            hidden_states = maybe_checkpoint(
                self.remat_sub, resnet, hidden_states, temb, image_only_indicator)
            hidden_states = maybe_checkpoint(
                self.remat_sub, attn, hidden_states, encoder_hidden_states, image_only_indicator)
            output_states += (hidden_states,)
        if self.downsamplers is not None:
            hidden_states = self.downsamplers[0](hidden_states)
            output_states += (hidden_states,)
        return hidden_states, output_states


class UNetMidBlockSpatioTemporal(nn.Module):
    def __init__(
        self,
        in_channels,
        num_layers=1,
        transformer_layers_per_block=1,
        num_attention_heads=1,
        cross_attention_dim=1024,
        temb_channels=1280,
        temporal_layout="seq",
        remat_sub=False,
    ):
        super().__init__()
        self.remat_sub = remat_sub
        self.resnets = nn.ModuleList(
            [_resnet(in_channels, in_channels, temb_channels) for _ in range(num_layers + 1)]
        )
        self.attentions = nn.ModuleList(
            [_transformer(in_channels, num_attention_heads, transformer_layers_per_block,
                          cross_attention_dim, temporal_layout)
             for _ in range(num_layers)]
        )

    def forward(self, hidden_states, temb, encoder_hidden_states, image_only_indicator):
        hidden_states = maybe_checkpoint(
            self.remat_sub, self.resnets[0], hidden_states, temb, image_only_indicator)
        for attn, resnet in zip(self.attentions, self.resnets[1:]):
            hidden_states = maybe_checkpoint(
                self.remat_sub, attn, hidden_states, encoder_hidden_states, image_only_indicator)
            hidden_states = maybe_checkpoint(
                self.remat_sub, resnet, hidden_states, temb, image_only_indicator)
        return hidden_states


def _up_in_channels(i, num_layers, in_channels, prev_output_channel, out_channels):
    skip = in_channels if i == num_layers - 1 else out_channels
    return (prev_output_channel if i == 0 else out_channels) + skip


class UpBlockSpatioTemporal(nn.Module):
    def __init__(
        self, in_channels, prev_output_channel, out_channels, num_layers=3, add_upsample=True,
        temb_channels=1280, remat_sub=False,
    ):
        super().__init__()
        self.remat_sub = remat_sub
        self.resnets = nn.ModuleList(
            [_resnet(_up_in_channels(i, num_layers, in_channels, prev_output_channel,
                                     out_channels), out_channels, temb_channels)
             for i in range(num_layers)]
        )
        self.upsamplers = (
            nn.ModuleList([Upsample2D(out_channels, out_channels)]) if add_upsample else None
        )

    def forward(self, hidden_states, res_hidden_states_tuple, temb, image_only_indicator):
        for resnet in self.resnets:
            res_hidden = res_hidden_states_tuple[-1]
            res_hidden_states_tuple = res_hidden_states_tuple[:-1]
            hidden_states = torch.cat([hidden_states, res_hidden], dim=1)
            hidden_states = maybe_checkpoint(
                self.remat_sub, resnet, hidden_states, temb, image_only_indicator)
        if self.upsamplers is not None:
            hidden_states = self.upsamplers[0](hidden_states)
        return hidden_states


class CrossAttnUpBlockSpatioTemporal(nn.Module):
    def __init__(
        self,
        in_channels,
        prev_output_channel,
        out_channels,
        num_layers=3,
        transformer_layers_per_block=1,
        num_attention_heads=1,
        cross_attention_dim=1024,
        add_upsample=True,
        temb_channels=1280,
        temporal_layout="seq",
        remat_sub=False,
    ):
        super().__init__()
        self.remat_sub = remat_sub
        self.resnets = nn.ModuleList(
            [_resnet(_up_in_channels(i, num_layers, in_channels, prev_output_channel,
                                     out_channels), out_channels, temb_channels)
             for i in range(num_layers)]
        )
        self.attentions = nn.ModuleList(
            [_transformer(out_channels, num_attention_heads, transformer_layers_per_block,
                          cross_attention_dim, temporal_layout)
             for _ in range(num_layers)]
        )
        self.upsamplers = (
            nn.ModuleList([Upsample2D(out_channels, out_channels)]) if add_upsample else None
        )

    def forward(
        self, hidden_states, res_hidden_states_tuple, temb, encoder_hidden_states,
        image_only_indicator,
    ):
        for resnet, attn in zip(self.resnets, self.attentions):
            res_hidden = res_hidden_states_tuple[-1]
            res_hidden_states_tuple = res_hidden_states_tuple[:-1]
            hidden_states = torch.cat([hidden_states, res_hidden], dim=1)
            hidden_states = maybe_checkpoint(
                self.remat_sub, resnet, hidden_states, temb, image_only_indicator)
            hidden_states = maybe_checkpoint(
                self.remat_sub, attn, hidden_states, encoder_hidden_states, image_only_indicator)
        if self.upsamplers is not None:
            hidden_states = self.upsamplers[0](hidden_states)
        return hidden_states
