"""UNetSpatioTemporalConditionModel, the SVD video UNet.

Counterpart of ``ctrlv_tpu/models/unet_st.py``. Input (B, F, H, W, C_in)
latents, the EDM continuous timestep, added_time_ids (fps-1, motion bucket,
noise aug), and optionally the ControlNet's down and mid residuals; output
(B, F, H, W, 4). ``UNetSpatioTemporalConditionModelWithBBoxCond`` is the
legacy bbox-cond variant, which no pipeline runs: the UNet plus
``encode_bbox_frame``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from .blocks_st import (
    CrossAttnDownBlockSpatioTemporal,
    CrossAttnUpBlockSpatioTemporal,
    DownBlockSpatioTemporal,
    UNetMidBlockSpatioTemporal,
    UpBlockSpatioTemporal,
    maybe_checkpoint,
)
from .layers import GroupNorm, TimestepEmbedding, get_timestep_embedding


@dataclasses.dataclass(frozen=True)
class UNetSTConfig:
    """SVD-XT UNet config: the JAX package's fields and defaults that shape
    the model."""

    in_channels: int = 8
    out_channels: int = 4
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlockSpatioTemporal",
        "CrossAttnDownBlockSpatioTemporal",
        "CrossAttnDownBlockSpatioTemporal",
        "DownBlockSpatioTemporal",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlockSpatioTemporal",
        "CrossAttnUpBlockSpatioTemporal",
        "CrossAttnUpBlockSpatioTemporal",
        "CrossAttnUpBlockSpatioTemporal",
    )
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 768
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    transformer_layers_per_block: int = 1
    num_attention_heads: Tuple[int, ...] = (5, 10, 20, 20)

    @classmethod
    def tiny(cls) -> "UNetSTConfig":
        """Small config for tests: same topology, tiny widths."""
        return cls(
            block_out_channels=(32, 64, 64, 64),
            num_attention_heads=(1, 2, 2, 2),
            cross_attention_dim=48,
            addition_time_embed_dim=16,
            projection_class_embeddings_input_dim=48,
        )

    @classmethod
    def micro(cls) -> "UNetSTConfig":
        """Minimal-depth config (2 blocks, 1 layer each): every block kind
        at a fraction of tiny()'s size."""
        return cls(
            down_block_types=("CrossAttnDownBlockSpatioTemporal", "DownBlockSpatioTemporal"),
            up_block_types=("UpBlockSpatioTemporal", "CrossAttnUpBlockSpatioTemporal"),
            block_out_channels=(32, 32),
            num_attention_heads=(1, 1),
            layers_per_block=1,
            cross_attention_dim=48,
            addition_time_embed_dim=16,
            projection_class_embeddings_input_dim=48,
        )


def remat_flags(gradient_checkpointing: bool, remat_granularity: str):
    """(checkpoint whole blocks, checkpoint each ResBlock and transformer):
    "block" keeps fewer boundaries and recomputes more at once, "sub" has the
    lower peak in the backward pass."""
    if remat_granularity not in ("block", "sub"):
        raise ValueError(f"remat_granularity {remat_granularity!r} is not 'block' or 'sub'")
    remat_sub = gradient_checkpointing and remat_granularity == "sub"
    return gradient_checkpointing and not remat_sub, remat_sub


def make_down_blocks(cfg: UNetSTConfig, temporal_layout: str = "seq",
                     remat_sub: bool = False) -> nn.ModuleList:
    """The down path shared by the UNet and the ControlNet."""
    blocks = []
    temb = 4 * cfg.block_out_channels[0]
    out_ch = cfg.block_out_channels[0]
    for i, block_type in enumerate(cfg.down_block_types):
        in_ch, out_ch = out_ch, cfg.block_out_channels[i]
        add_downsample = i != len(cfg.block_out_channels) - 1
        if block_type == "CrossAttnDownBlockSpatioTemporal":
            blocks.append(
                CrossAttnDownBlockSpatioTemporal(
                    in_ch, out_ch, cfg.layers_per_block, cfg.transformer_layers_per_block,
                    cfg.num_attention_heads[i], cfg.cross_attention_dim, add_downsample, temb,
                    temporal_layout=temporal_layout, remat_sub=remat_sub,
                )
            )
        elif block_type == "DownBlockSpatioTemporal":
            blocks.append(
                DownBlockSpatioTemporal(in_ch, out_ch, cfg.layers_per_block, add_downsample, temb,
                                        remat_sub=remat_sub)
            )
        else:
            raise ValueError(block_type)
    return nn.ModuleList(blocks)


def run_down_blocks(blocks, sample, emb, encoder_hidden_states, image_only_indicator,
                    remat_block: bool = False):
    """The down path: returns the last hidden state and every residual,
    starting with the input (conv_in's output). ``remat_block`` checkpoints
    each block as a whole."""
    down_res = (sample,)
    for block in blocks:
        if isinstance(block, CrossAttnDownBlockSpatioTemporal):
            sample, res = maybe_checkpoint(
                remat_block, block, sample, emb, encoder_hidden_states, image_only_indicator)
        else:
            sample, res = maybe_checkpoint(remat_block, block, sample, emb, image_only_indicator)
        down_res += res
    return sample, down_res


def make_mid_block(cfg: UNetSTConfig, temporal_layout: str = "seq",
                   remat_sub: bool = False) -> UNetMidBlockSpatioTemporal:
    return UNetMidBlockSpatioTemporal(
        cfg.block_out_channels[-1],
        transformer_layers_per_block=cfg.transformer_layers_per_block,
        num_attention_heads=cfg.num_attention_heads[-1],
        cross_attention_dim=cfg.cross_attention_dim,
        temb_channels=4 * cfg.block_out_channels[0],
        temporal_layout=temporal_layout,
        remat_sub=remat_sub,
    )


def embed_time(model, timestep, added_time_ids, batch: int, dtype):
    """Time plus micro-conditioning embedding, (B, 4*C0), of the UNet or the
    ControlNet (both own ``time_embedding`` and ``add_embedding``). The
    sinusoids are f32 and cast to the model dtype after."""
    cfg = model.config
    device = added_time_ids.device
    timesteps = torch.as_tensor(timestep, dtype=torch.float32, device=device).reshape(-1)
    t_emb = get_timestep_embedding(timesteps.expand(batch), cfg.block_out_channels[0])
    emb = model.time_embedding(t_emb.to(dtype))
    time_embeds = get_timestep_embedding(
        added_time_ids.reshape(-1), cfg.addition_time_embed_dim
    ).reshape(batch, -1)
    return emb + model.add_embedding(time_embeds.to(dtype))


def to_frames_nchw(video, dtype):
    """(B, F, H, W, C) -> (B*F, C, H, W) in ``dtype``, contiguous: a permuted
    view would make the convolutions answer channels-last, and the norm
    kernel reads channels-first."""
    b, f, h, w, c = video.shape
    return video.to(dtype).permute(0, 1, 4, 2, 3).reshape(b * f, c, h, w).contiguous()


def flatten_frames(sample, emb, encoder_hidden_states, dtype):
    """Batch-and-frame flattening at the top of the UNet and the ControlNet:
    the latents to (B*F, C, H, W), the embedding and the CLIP context
    repeated per frame, and the all-zero image_only_indicator (B, F)."""
    batch, num_frames = sample.shape[:2]
    return (
        to_frames_nchw(sample, dtype),
        emb.repeat_interleave(num_frames, dim=0),
        encoder_hidden_states.to(dtype).repeat_interleave(num_frames, dim=0),
        torch.zeros(batch, num_frames, dtype=dtype, device=sample.device),
    )


class UNetSpatioTemporalConditionModel(nn.Module):
    """``temporal_layout`` ("seq" or "frames_major") goes to every
    TransformerSpatioTemporalModel; it is a constructor keyword and no field
    of the config, which both packages share. The two layouts compute the
    same function from the same weights.

    ``gradient_checkpointing`` with ``remat_granularity`` "block" or "sub"
    checkpoints the down, mid and up blocks, or each ResBlock and
    transformer inside them, while a gradient is being recorded; like the
    layout they are constructor keywords, as in the JAX package."""

    def __init__(self, config: UNetSTConfig = UNetSTConfig(), temporal_layout: str = "seq",
                 gradient_checkpointing: bool = False, remat_granularity: str = "block"):
        super().__init__()
        cfg = self.config = config
        self.remat_block, remat_sub = remat_flags(gradient_checkpointing, remat_granularity)
        c0 = cfg.block_out_channels[0]
        self.conv_in = nn.Conv2d(cfg.in_channels, c0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(c0, c0 * 4)
        self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim, c0 * 4)
        self.down_blocks = make_down_blocks(cfg, temporal_layout, remat_sub)
        self.mid_block = make_mid_block(cfg, temporal_layout, remat_sub)

        rev_ch = tuple(reversed(cfg.block_out_channels))
        rev_heads = tuple(reversed(cfg.num_attention_heads))
        up = []
        out_ch = rev_ch[0]
        for i, block_type in enumerate(cfg.up_block_types):
            prev_ch, out_ch = out_ch, rev_ch[i]
            in_ch = rev_ch[min(i + 1, len(rev_ch) - 1)]
            add_upsample = i != len(rev_ch) - 1
            num_layers = cfg.layers_per_block + 1
            if block_type == "CrossAttnUpBlockSpatioTemporal":
                up.append(
                    CrossAttnUpBlockSpatioTemporal(
                        in_ch, prev_ch, out_ch, num_layers, cfg.transformer_layers_per_block,
                        rev_heads[i], cfg.cross_attention_dim, add_upsample, c0 * 4,
                        temporal_layout=temporal_layout, remat_sub=remat_sub,
                    )
                )
            elif block_type == "UpBlockSpatioTemporal":
                up.append(
                    UpBlockSpatioTemporal(in_ch, prev_ch, out_ch, num_layers, add_upsample, c0 * 4,
                                          remat_sub=remat_sub)
                )
            else:
                raise ValueError(block_type)
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = GroupNorm(32, c0, 1e-5, act="silu")
        self.conv_out = nn.Conv2d(c0, cfg.out_channels, 3, padding=1)

    def forward(
        self,
        sample,  # (B, F, H, W, C_in)
        timestep,  # scalar or (B,)
        encoder_hidden_states,  # (B, 1, cross_dim)
        added_time_ids,  # (B, 3)
        down_block_additional_residuals=None,  # tuple of (B*F, C, h, w)
        mid_block_additional_residuals=None,  # (B*F, C, h, w)
    ):
        dtype = self.conv_in.weight.dtype
        batch, num_frames = sample.shape[:2]
        emb = embed_time(self, timestep, added_time_ids, batch, dtype)
        sample, emb, encoder_hidden_states, image_only_indicator = flatten_frames(
            sample, emb, encoder_hidden_states, dtype
        )

        sample, down_res = run_down_blocks(
            self.down_blocks, self.conv_in(sample), emb, encoder_hidden_states,
            image_only_indicator, self.remat_block,
        )
        if down_block_additional_residuals is not None:
            down_res = tuple(r + c for r, c in zip(down_res, down_block_additional_residuals))

        sample = maybe_checkpoint(
            self.remat_block, self.mid_block, sample, emb, encoder_hidden_states,
            image_only_indicator)
        if mid_block_additional_residuals is not None:
            sample = sample + mid_block_additional_residuals

        for block in self.up_blocks:
            n = len(block.resnets)
            res, down_res = down_res[-n:], down_res[:-n]
            if isinstance(block, CrossAttnUpBlockSpatioTemporal):
                sample = maybe_checkpoint(
                    self.remat_block, block, sample, res, emb, encoder_hidden_states,
                    image_only_indicator)
            else:
                sample = maybe_checkpoint(
                    self.remat_block, block, sample, res, emb, image_only_indicator)

        sample = self.conv_out(self.conv_norm_out(sample))
        out = sample.reshape((batch, num_frames) + sample.shape[1:])
        return out.permute(0, 1, 3, 4, 2)


class UNetSpatioTemporalConditionModelWithBBoxCond(UNetSpatioTemporalConditionModel):
    """The UNet-ST plus a rezero ``BBOXFrameAttention`` (``num_bbox_attn_layers``
    layers, heads = num_frames, head dim = 4 * num_frames) that maps the first
    frame latent to per-frame conditioning latents (``encode_bbox_frame``).
    ``num_frames`` is a constructor keyword: the port's config has no field
    for it.

    As in the JAX module, the attention is built with no cross-attention
    (``cross_attention_dim=None``), so the encoded objects reach nothing:
    ``encode_bbox_frame`` takes them and its output does not depend on them
    (ROADMAP §3)."""

    def __init__(self, config: UNetSTConfig = UNetSTConfig(), num_frames: int = 25,
                 num_bbox_attn_layers: int = 8, **kwargs):
        from .bbox_attention import BBOXFrameAttention

        super().__init__(config, **kwargs)
        self.num_frames = num_frames
        self.bbox_frame_attention = BBOXFrameAttention(
            num_frames=num_frames, in_channels=config.out_channels,
            out_channels=config.out_channels * num_frames, num_layers=num_bbox_attn_layers,
            cross_attention_dim=None, norm_num_groups=4,
        )

    def encode_bbox_frame(self, frame_latent: torch.Tensor,
                          encoded_objects: Optional[torch.Tensor]) -> torch.Tensor:
        """(B, 4, h, w) + (B, F, O, D) -> (B, F, 4, h, w) conditioning latents:
        the output's channels split frame-major, the reference's
        reshape(b, F, C, H, W)."""
        b, c, h, w = frame_latent.shape
        tokens = None
        if encoded_objects is not None:
            bb, f, o, d = encoded_objects.shape
            tokens = encoded_objects.reshape(bb, f * o, d)
        out = self.bbox_frame_attention(frame_latent, tokens)
        return out.view(b, self.num_frames, c, h, w)
