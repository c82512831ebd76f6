"""The legacy image UNet with object conditioning (UNet2DConditionModel).

Counterpart of ``ctrlv_tpu/models/unet_2d.py``: the SD1.x 4-level UNet built
from the ``ResnetBlock2D`` and ``BasicTransformerBlock`` of the video UNet,
with the reference's two additions:

- ``addition_embed_type == "object"``: a ``TextTimeEmbedding``
  (attention-pooled object tokens -> the time-embedding width) scaled by the
  learned scalar ``object_w`` and added to the time embedding;
- ``encoder_hid_dim_type == "text_object_proj"``: the object tokens,
  projected (``encoder_hid_proj``), padded or cut to the text length and
  scaled by the learned scalar ``object_u``, added onto the text states.

``attention_head_dim`` is the number of heads, as in the reference's SD1.x
config (8: head dims 40, 80 and 160 at SD1.x width). Norm eps: 1e-5 in the
ResBlocks and ``conv_norm_out``, 1e-6 in ``Transformer2D.norm`` and in the
two LayerNorms of ``TextTimeEmbedding`` (flax's default).

Parameter names are diffusers' (``down_blocks.0.resnets.0``,
``down_blocks.0.downsamplers.0.conv``, ``mid_block.attentions.0``,
``up_blocks.1.upsamplers.0.conv``, ``add_embedding``, ``encoder_hid_proj``),
which ``convert.py`` gives the JAX module's names. The model's input and
output are NHWC, as the JAX module's; inside it is contiguous NCHW, and it
computes in its parameters' dtype (bf16 on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (
    Attention,
    BasicTransformerBlock,
    Downsample2D,
    GroupNorm,
    LayerNorm,
    TimestepEmbedding,
    Upsample2D,
    get_timestep_embedding,
)
from .resnet import ResnetBlock2D


@dataclasses.dataclass(frozen=True)
class UNet2DConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_head_dim: int = 8
    addition_embed_type: Optional[str] = None  # "object"
    encoder_hid_dim_type: Optional[str] = None  # "text_object_proj"
    object_dim: int = 768

    @classmethod
    def tiny(cls, **kw) -> "UNet2DConfig":
        return cls(
            block_out_channels=(32, 64),
            cross_attention_dim=32,
            attention_head_dim=4,
            object_dim=32,
            **kw,
        )


class Transformer2D(nn.Module):
    """Spatial transformer: GN + 1x1 proj + blocks + 1x1 proj + residual."""

    def __init__(self, in_channels: int, num_heads: int, num_layers: int = 1,
                 cross_attention_dim: int = 768):
        super().__init__()
        c = in_channels
        self.norm = GroupNorm(32, c, 1e-6)
        self.proj_in = nn.Conv2d(c, c, 1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(c, num_heads, c // num_heads, cross_attention_dim)
            for _ in range(num_layers))
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x, context):
        """x (B, C, H, W) contiguous; context (B, T, cross_dim)."""
        b, c, h, w = x.shape
        z = self.proj_in(self.norm(x))
        z = z.permute(0, 2, 3, 1).reshape(b, h * w, c).contiguous()
        for block in self.transformer_blocks:
            z = block(z, context)
        z = self.proj_out(z.reshape(b, h, w, c).permute(0, 3, 1, 2).contiguous())
        return x + z


class TextTimeEmbedding(nn.Module):
    """Attention-pooled token embedding -> the time-embedding width: a learned
    query (``pool_query``) attends over the normed tokens."""

    def __init__(self, dim: int, time_embed_dim: int, num_heads: int = 8):
        super().__init__()
        self.norm1 = LayerNorm(dim, 1e-6)
        self.pool_query = nn.Parameter(0.02 * torch.randn(1, 1, dim))
        self.pool_attn = Attention(dim, num_heads, max(dim // num_heads, 1),
                                   cross_attention_dim=dim)
        self.proj = nn.Linear(dim, time_embed_dim)
        self.norm2 = LayerNorm(time_embed_dim, 1e-6)

    def forward(self, tokens):  # (B, T, D)
        dtype = self.proj.weight.dtype
        x = self.norm1(tokens.contiguous()).to(dtype)
        q = self.pool_query.to(dtype).expand(x.shape[0], 1, x.shape[-1])
        pooled = self.pool_attn(q, context=x)[:, 0]
        return self.norm2(self.proj(pooled))


class _Level(nn.Module):
    """One level of the UNet: its ResBlocks, transformers (if any) and
    resampler (``downsamplers`` or ``upsamplers``, if any)."""

    def __init__(self, resnets, attentions, sampler_name: Optional[str] = None, sampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        else:
            self.attentions = None
        if sampler is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))


class UNet2DConditionModel(nn.Module):
    def __init__(self, config: UNet2DConfig = UNet2DConfig()):
        super().__init__()
        cfg = self.config = config
        ch = cfg.block_out_channels
        c0, temb = ch[0], ch[0] * 4
        heads, cross = cfg.attention_head_dim, cfg.cross_attention_dim
        self.conv_in = nn.Conv2d(cfg.in_channels, c0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(c0, temb)
        if cfg.addition_embed_type == "object":
            self.object_w = nn.Parameter(torch.ones(1))
            self.add_embedding = TextTimeEmbedding(cfg.object_dim, temb)
        if cfg.encoder_hid_dim_type == "text_object_proj":
            self.object_u = nn.Parameter(torch.ones(1))
            self.encoder_hid_proj = nn.Linear(cfg.object_dim, cross)

        levels = len(ch)
        skips, cur, down = [c0], c0, []
        for i, out_ch in enumerate(ch):
            final = i == levels - 1
            resnets, attns = [], []
            for j in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(cur, out_ch, temb, eps=1e-5))
                if not final:
                    attns.append(Transformer2D(out_ch, heads, cross_attention_dim=cross))
                cur = out_ch
                skips.append(cur)
            sampler = None if final else Downsample2D(out_ch, out_ch)
            if not final:
                skips.append(cur)
            down.append(_Level(resnets, attns, "downsamplers", sampler))
        self.down_blocks = nn.ModuleList(down)

        self.mid_block = _Level(
            [ResnetBlock2D(cur, cur, temb, eps=1e-5), ResnetBlock2D(cur, cur, temb, eps=1e-5)],
            [Transformer2D(cur, heads, cross_attention_dim=cross)])

        up = []
        for i, out_ch in enumerate(reversed(ch)):
            resnets, attns = [], []
            for j in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock2D(cur + skips.pop(), out_ch, temb, eps=1e-5))
                if i != 0:
                    attns.append(Transformer2D(out_ch, heads, cross_attention_dim=cross))
                cur = out_ch
            sampler = Upsample2D(out_ch, out_ch) if i != levels - 1 else None
            up.append(_Level(resnets, attns, "upsamplers", sampler))
        self.up_blocks = nn.ModuleList(up)

        self.conv_norm_out = GroupNorm(32, c0, 1e-5, act="silu")
        self.conv_out = nn.Conv2d(c0, cfg.out_channels, 3, padding=1)

    def forward(
        self,
        sample: torch.Tensor,  # (B, H, W, C)
        timestep,  # scalar or (B,)
        encoder_hidden_states: torch.Tensor,  # (B, T, cross_dim) text states
        object_embs: Optional[torch.Tensor] = None,  # (B, N, object_dim)
    ) -> torch.Tensor:
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        b = sample.shape[0]
        timesteps = torch.as_tensor(timestep, dtype=torch.float32,
                                    device=sample.device).reshape(-1).expand(b)
        t_emb = get_timestep_embedding(timesteps, cfg.block_out_channels[0])
        emb = self.time_embedding(t_emb.to(dtype))

        if cfg.addition_embed_type == "object" and object_embs is not None:
            aug = self.add_embedding(object_embs)
            emb = emb + self.object_w.to(emb.dtype) * aug

        context = encoder_hidden_states.to(dtype)
        if cfg.encoder_hid_dim_type == "text_object_proj" and object_embs is not None:
            proj = self.encoder_hid_proj(object_embs.to(dtype))
            t_len, o_len = context.shape[1], proj.shape[1]
            if o_len < t_len:
                proj = F.pad(proj, (0, 0, 0, t_len - o_len))
            context = context + self.object_u.to(context.dtype) * proj[:, :t_len]

        x = self.conv_in(sample.to(dtype).permute(0, 3, 1, 2).contiguous())
        skips = [x]
        for level in self.down_blocks:
            for j, resnet in enumerate(level.resnets):
                x = resnet(x, emb)
                if level.attentions is not None:
                    x = level.attentions[j](x, context)
                skips.append(x)
            if hasattr(level, "downsamplers"):
                x = level.downsamplers[0](x)
                skips.append(x)

        mid = self.mid_block
        x = mid.resnets[1](mid.attentions[0](mid.resnets[0](x, emb), context), emb)

        for level in self.up_blocks:
            for j, resnet in enumerate(level.resnets):
                x = resnet(torch.cat([x, skips.pop()], dim=1), emb)
                if level.attentions is not None:
                    x = level.attentions[j](x, context)
            if hasattr(level, "upsamplers"):
                x = level.upsamplers[0](x)

        x = self.conv_out(self.conv_norm_out(x))
        return x.permute(0, 2, 3, 1)
