"""Plain float32 reference of Stable Video Diffusion img2vid-XT as Ctrl-V runs it.

The spatio-temporal UNet, Ctrl-V's spatio-temporal ControlNet, the temporal
VAE (SD encoder, temporal decoder) and the CLIP ViT-H/14 image encoder, with
the diffusers and transformers parameter names, written from the published
architecture in plain ``torch`` operations: no kernel, no fused path, no
batching trick. It is the benchmark's frozen yardstick. It imports nothing
of the program under test and nothing of JAX, and it computes what the
program's models compute (the program's "seq" and "frames_major" temporal
layouts are one function; this file computes the "seq" form).

Departures from a literal transcription, none of which changes a result:
attention is computed in blocks of rows so that its scores fit in memory,
and a cross-attention to a single key token is computed as
``to_out(to_v(context))`` broadcast over the queries, which is what the
softmax over one key gives exactly.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# Scores of one block of attention rows stay under this many elements.
ATTENTION_BLOCK_ELEMS = 1 << 28


def attention(q, k, v, scale: float):
    """softmax(q k^T * scale) v over (N, S, D) operands, in blocks of rows."""
    n, sq, _ = q.shape
    sk = k.shape[1]
    rows = max(1, ATTENTION_BLOCK_ELEMS // max(1, sq * sk))
    out = []
    for i in range(0, n, rows):
        scores = torch.bmm(q[i:i + rows], k[i:i + rows].transpose(1, 2)) * scale
        out.append(torch.bmm(torch.softmax(scores, dim=-1), v[i:i + rows]))
    return out[0] if len(out) == 1 else torch.cat(out)


def split_heads(x, heads: int):
    b, s, c = x.shape
    return x.reshape(b, s, heads, c // heads).transpose(1, 2).reshape(b * heads, s, c // heads)


def merge_heads(x, heads: int):
    bh, s, d = x.shape
    return x.reshape(bh // heads, heads, s, d).transpose(1, 2).reshape(bh // heads, s, heads * d)


class GroupNorm(nn.Module):
    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6, act=None):
        super().__init__()
        self.num_groups, self.eps, self.act = num_groups, eps, act
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        y = F.group_norm(x, self.num_groups, self.weight, self.bias, self.eps)
        return F.silu(y) if self.act == "silu" else y


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)


def timestep_embedding(timesteps, dim: int, max_period: float = 10000.0):
    """Sinusoidal embedding, cos first (flip_sin_to_cos), no frequency shift."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_channels: int, time_embed_dim: int, out_dim: Optional[int] = None):
        super().__init__()
        self.linear_1 = nn.Linear(in_channels, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, out_dim or time_embed_dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class AlphaBlender(nn.Module):
    """alpha * spatial + (1 - alpha) * temporal, alpha = sigmoid(mix_factor)
    (every frame of a video is a video frame here), the roles swapped in
    the ResBlocks. ``init_alpha`` is the constructor's value of the factor."""

    def __init__(self, alpha: float, switch: bool = False):
        super().__init__()
        self.init_alpha, self.switch = alpha, switch
        self.mix_factor = nn.Parameter(torch.tensor([alpha]))

    def forward(self, spatial, temporal):
        alpha = torch.sigmoid(self.mix_factor)[0]
        if self.switch:
            alpha = 1.0 - alpha
        return alpha * spatial + (1.0 - alpha) * temporal


class Attention(nn.Module):
    """diffusers ``Attention``: (B, S, C) queries, optional context."""

    def __init__(self, query_dim: int, heads: int, dim_head: int, cross_attention_dim=None,
                 qkv_bias: bool = False, residual_connection: bool = False,
                 norm_num_groups: Optional[int] = None, eps: float = 1e-5):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.query_dim = heads, dim_head, query_dim
        self.residual_connection = residual_connection
        self.group_norm = (GroupNorm(norm_num_groups, query_dim, eps)
                           if norm_num_groups is not None else None)
        ctx = cross_attention_dim or query_dim
        self.to_q = nn.Linear(query_dim, inner, bias=qkv_bias)
        self.to_k = nn.Linear(ctx, inner, bias=qkv_bias)
        self.to_v = nn.Linear(ctx, inner, bias=qkv_bias)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x, context=None):
        residual = x
        if self.group_norm is not None:
            x = self.group_norm(x.transpose(1, 2)).transpose(1, 2)
        b, sq, _ = x.shape
        if context is not None and context.shape[1] == 1:
            out = self.to_out[0](self.to_v(context)).expand(b, sq, self.query_dim)
        else:
            ctx = x if context is None else context
            q, k, v = (split_heads(t, self.heads)
                       for t in (self.to_q(x), self.to_k(ctx), self.to_v(ctx)))
            out = merge_heads(attention(q, k, v, self.dim_head ** -0.5), self.heads)
            out = self.to_out[0](out)
        return out + residual if self.residual_connection else out


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, cross_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, dim_head)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, heads, dim_head, cross_attention_dim=cross_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class TemporalBasicTransformerBlock(nn.Module):
    """Over (B*S, F, C): feed-forward in, self-attention over the frames,
    cross-attention to the first frame's CLIP token, feed-forward."""

    def __init__(self, dim: int, heads: int, dim_head: int, cross_dim: int):
        super().__init__()
        self.norm_in = LayerNorm(dim)
        self.ff_in = FeedForward(dim)
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, dim_head)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, heads, dim_head, cross_attention_dim=cross_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = self.ff_in(self.norm_in(x)) + x
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, temb: Optional[int], eps: float):
        super().__init__()
        self.norm1 = GroupNorm(32, cin, eps, act="silu")
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb, cout) if temb is not None else None
        self.norm2 = GroupNorm(32, cout, eps, act="silu")
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x))
        if temb is not None and self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        return h + (self.conv_shortcut(x) if self.conv_shortcut is not None else x)


class TemporalResnetBlock(nn.Module):
    """(3, 1, 1) convolutions over (B, C, F, H, W)."""

    def __init__(self, cin: int, cout: int, temb: Optional[int], eps: float):
        super().__init__()
        self.norm1 = GroupNorm(32, cin, eps, act="silu")
        self.conv1 = nn.Conv3d(cin, cout, (3, 1, 1), padding=(1, 0, 0))
        self.time_emb_proj = nn.Linear(temb, cout) if temb is not None else None
        self.norm2 = GroupNorm(32, cout, eps, act="silu")
        self.conv2 = nn.Conv3d(cout, cout, (3, 1, 1), padding=(1, 0, 0))
        self.conv_shortcut = nn.Conv3d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x))
        if temb is not None and self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb)).transpose(1, 2)[:, :, :, None, None]
        h = self.conv2(self.norm2(h))
        return h + (self.conv_shortcut(x) if self.conv_shortcut is not None else x)


class SpatioTemporalResBlock(nn.Module):
    """(B*F, C, H, W) -> spatial ResBlock, temporal ResBlock, learned blend."""

    def __init__(self, cin: int, cout: int, temb: Optional[int], eps: float, merge: float):
        super().__init__()
        self.spatial_res_block = ResnetBlock2D(cin, cout, temb, eps)
        self.temporal_res_block = TemporalResnetBlock(cout, cout, temb, eps)
        self.time_mixer = AlphaBlender(merge, switch=True)

    def forward(self, x, temb, frames: int):
        x = self.spatial_res_block(x, temb)
        bf, c, h, w = x.shape
        b = bf // frames
        x5 = x.reshape(b, frames, c, h, w).permute(0, 2, 1, 3, 4)
        tf = temb.reshape(b, frames, -1) if temb is not None else None
        xt = self.temporal_res_block(x5, tf).permute(0, 2, 1, 3, 4).reshape(bf, c, h, w)
        return self.time_mixer(x, xt)


class TransformerSpatioTemporalModel(nn.Module):
    def __init__(self, heads: int, dim_head: int, channels: int, cross_dim: int):
        super().__init__()
        inner = heads * dim_head
        self.channels = channels
        self.norm = GroupNorm(32, channels, 1e-6)
        self.proj_in = nn.Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, dim_head, cross_dim)])
        self.temporal_transformer_blocks = nn.ModuleList(
            [TemporalBasicTransformerBlock(inner, heads, dim_head, cross_dim)])
        self.time_pos_embed = TimestepEmbedding(channels, channels * 4, out_dim=channels)
        self.time_mixer = AlphaBlender(0.5)
        self.proj_out = nn.Linear(inner, channels)

    def forward(self, x, context, frames: int):
        """x (B*F, C, H, W); context (B*F, 1, cross) one CLIP token a frame."""
        bf, c, height, width = x.shape
        b, seq = bf // frames, height * width
        time_context = context.reshape(b, frames, *context.shape[1:])[:, :1]
        time_context = time_context.expand(b, seq, *context.shape[1:]).reshape(
            b * seq, *context.shape[1:])
        h = self.norm(x).permute(0, 2, 3, 1).reshape(bf, seq, c)
        h = self.proj_in(h)
        inner = h.shape[-1]
        frame_ids = torch.arange(frames, device=x.device).repeat(b)
        emb = self.time_pos_embed(timestep_embedding(frame_ids, c))[:, None, :]
        for block, tblock in zip(self.transformer_blocks, self.temporal_transformer_blocks):
            h = block(h, context)
            hm = (h + emb).reshape(b, frames, seq, inner).transpose(1, 2).reshape(
                b * seq, frames, inner)
            hm = tblock(hm, time_context)
            hm = hm.reshape(b, seq, frames, inner).transpose(1, 2).reshape(bf, seq, inner)
            h = self.time_mixer(h, hm)
        h = self.proj_out(h).reshape(bf, height, width, c).permute(0, 3, 1, 2)
        return x + h


class _Sampler(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1)


class Downsample2D(_Sampler):
    def __init__(self, cin: int, cout: int, vae: bool = False):
        super().__init__(cin, cout)
        self.conv = nn.Conv2d(cin, cout, 3, stride=2, padding=0 if vae else 1)
        self.vae = vae

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)) if self.vae else x)


class Upsample2D(_Sampler):
    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


def _st_resnet(cin, cout, temb):
    return SpatioTemporalResBlock(cin, cout, temb, eps=1e-5, merge=0.5)


def _transformer(channels, heads, cross_dim):
    return TransformerSpatioTemporalModel(heads, channels // heads, channels, cross_dim)


class DownBlock(nn.Module):
    """Down block of the UNet: ResBlocks, with transformers where ``heads``."""

    def __init__(self, cin, cout, layers, heads, cross_dim, downsample, temb):
        super().__init__()
        self.resnets = nn.ModuleList(
            [_st_resnet(cin if i == 0 else cout, cout, temb) for i in range(layers)])
        if heads:
            self.attentions = nn.ModuleList(
                [_transformer(cout, heads, cross_dim) for _ in range(layers)])
        else:
            self.attentions = None
        self.downsamplers = nn.ModuleList([Downsample2D(cout, cout)]) if downsample else None

    def forward(self, x, temb, context, frames):
        out = ()
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb, frames)
            if self.attentions is not None:
                x = self.attentions[i](x, context, frames)
            out += (x,)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            out += (x,)
        return x, out


class MidBlock(nn.Module):
    def __init__(self, channels, heads, cross_dim, temb):
        super().__init__()
        self.resnets = nn.ModuleList([_st_resnet(channels, channels, temb) for _ in range(2)])
        self.attentions = nn.ModuleList([_transformer(channels, heads, cross_dim)])

    def forward(self, x, temb, context, frames):
        x = self.resnets[0](x, temb, frames)
        x = self.attentions[0](x, context, frames)
        return self.resnets[1](x, temb, frames)


class UpBlock(nn.Module):
    def __init__(self, cin, prev, cout, layers, heads, cross_dim, upsample, temb):
        super().__init__()
        chans = [(prev if i == 0 else cout) + (cin if i == layers - 1 else cout)
                 for i in range(layers)]
        self.resnets = nn.ModuleList([_st_resnet(c, cout, temb) for c in chans])
        if heads:
            self.attentions = nn.ModuleList(
                [_transformer(cout, heads, cross_dim) for _ in range(layers)])
        else:
            self.attentions = None
        self.upsamplers = nn.ModuleList([Upsample2D(cout, cout)]) if upsample else None

    def forward(self, x, skips, temb, context, frames):
        for i, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, skips[-1 - i]], dim=1), temb, frames)
            if self.attentions is not None:
                x = self.attentions[i](x, context, frames)
        return self.upsamplers[0](x) if self.upsamplers is not None else x


def _down_path(cfg: dict) -> nn.ModuleList:
    chans, heads = cfg["block_out_channels"], cfg["num_attention_heads"]
    temb, blocks, cout = 4 * chans[0], [], chans[0]
    for i, kind in enumerate(cfg["down_block_types"]):
        cin, cout = cout, chans[i]
        attn = heads[i] if kind.startswith("CrossAttn") else 0
        blocks.append(DownBlock(cin, cout, cfg["layers_per_block"], attn,
                                cfg["cross_attention_dim"], i != len(chans) - 1, temb))
    return nn.ModuleList(blocks)


class _Conditioned(nn.Module):
    """conv_in, the time and micro-conditioning embeddings, the down path and
    the mid block: what the UNet and the ControlNet share. With
    ``checkpoint_blocks`` set, each down, mid and up block drops its
    activations while a gradient is recorded and computes them again in the
    backward pass, so that the float32 reference of a training step fits on
    the card; the gradient is the same."""

    checkpoint_blocks = False

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        c0 = cfg["block_out_channels"][0]
        self.conv_in = nn.Conv2d(cfg["in_channels"], c0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(c0, 4 * c0)
        self.add_embedding = TimestepEmbedding(cfg["projection_class_embeddings_input_dim"], 4 * c0)

    def _embed(self, sample, timestep, context, added_time_ids):
        b, f = sample.shape[:2]
        c0 = self.cfg["block_out_channels"][0]
        t = torch.as_tensor(timestep, dtype=torch.float32, device=sample.device).reshape(-1)
        emb = self.time_embedding(timestep_embedding(t.expand(b), c0))
        ids = timestep_embedding(added_time_ids.reshape(-1), self.cfg["addition_time_embed_dim"])
        emb = emb + self.add_embedding(ids.reshape(b, -1))
        x = sample.float().permute(0, 1, 4, 2, 3).reshape(b * f, *sample.shape[4:],
                                                          *sample.shape[2:4])
        return x, emb.repeat_interleave(f, 0), context.float().repeat_interleave(f, 0), f

    def _block(self, block, *args):
        if self.checkpoint_blocks and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def _run_down(self, x, emb, context, frames):
        res = (x,)
        for block in self.down_blocks:
            x, out = self._block(block, x, emb, context, frames)
            res += out
        return x, res


class UNetSpatioTemporal(_Conditioned):
    """(B, F, h, w, in) latents -> (B, F, h, w, out) v-prediction."""

    def __init__(self, cfg: dict):
        super().__init__(cfg)
        chans, heads = cfg["block_out_channels"], cfg["num_attention_heads"]
        c0, cross = chans[0], cfg["cross_attention_dim"]
        self.down_blocks = _down_path(cfg)
        self.mid_block = MidBlock(chans[-1], heads[-1], cross, 4 * c0)
        rev, rheads, up, cout = chans[::-1], heads[::-1], [], chans[-1]
        for i, kind in enumerate(cfg["up_block_types"]):
            prev, cout = cout, rev[i]
            cin = rev[min(i + 1, len(rev) - 1)]
            attn = rheads[i] if kind.startswith("CrossAttn") else 0
            up.append(UpBlock(cin, prev, cout, cfg["layers_per_block"] + 1, attn, cross,
                              i != len(rev) - 1, 4 * c0))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = GroupNorm(32, c0, 1e-5, act="silu")
        self.conv_out = nn.Conv2d(c0, cfg["out_channels"], 3, padding=1)

    def forward(self, sample, timestep, context, added_time_ids, down_residuals=None,
                mid_residual=None):
        b = sample.shape[0]
        x, emb, ctx, f = self._embed(sample, timestep, context, added_time_ids)
        x, res = self._run_down(self.conv_in(x), emb, ctx, f)
        if down_residuals is not None:
            res = tuple(r + c for r, c in zip(res, down_residuals))
        x = self._block(self.mid_block, x, emb, ctx, f)
        if mid_residual is not None:
            x = x + mid_residual
        for block in self.up_blocks:
            n = len(block.resnets)
            skips, res = res[-n:], res[:-n]
            x = self._block(block, x, skips, emb, ctx, f)
        x = self.conv_out(self.conv_norm_out(x))
        return x.reshape(b, f, *x.shape[1:]).permute(0, 1, 3, 4, 2)


def down_residual_channels(cfg: dict) -> list:
    chans = cfg["block_out_channels"]
    out = [chans[0]]
    for i, c in enumerate(chans):
        out += [c] * cfg["layers_per_block"] + ([c] if i != len(chans) - 1 else [])
    return out


class ControlNetSpatioTemporal(_Conditioned):
    """The UNet's down and mid path over the latents plus ``control_conv_in``
    of the conditioning latents; one 1x1 conv per residual."""

    def __init__(self, cfg: dict):
        super().__init__(cfg)
        chans, heads = cfg["block_out_channels"], cfg["num_attention_heads"]
        c0 = chans[0]
        self.control_conv_in = nn.Conv2d(cfg["in_channels"] // 2, c0, 3, padding=1)
        self.down_blocks = _down_path(cfg)
        self.mid_block = MidBlock(chans[-1], heads[-1], cfg["cross_attention_dim"], 4 * c0)
        self.controlnet_down_blocks = nn.ModuleList(
            [nn.Conv2d(c, c, 1) for c in down_residual_channels(cfg)])
        self.controlnet_mid_block = nn.Conv2d(chans[-1], chans[-1], 1)

    def forward(self, sample, timestep, context, added_time_ids, control_cond, scale=1.0):
        x, emb, ctx, f = self._embed(sample, timestep, context, added_time_ids)
        b = control_cond.shape[0]
        cond = control_cond.float().permute(0, 1, 4, 2, 3).reshape(
            b * f, control_cond.shape[4], *control_cond.shape[2:4])
        x = self.conv_in(x) + self.control_conv_in(cond)
        x, res = self._run_down(x, emb, ctx, f)
        x = self._block(self.mid_block, x, emb, ctx, f)
        down = tuple(conv(r) * scale for conv, r in zip(self.controlnet_down_blocks, res))
        return down, self.controlnet_mid_block(x) * scale


# ---- the temporal VAE ----

def _attend(attn: Attention, x):
    b, c, h, w = x.shape
    out = attn(x.permute(0, 2, 3, 1).reshape(b, h * w, c))
    return out.reshape(b, h, w, c).permute(0, 3, 1, 2)


def _vae_attention(c: int, head_dim: int) -> Attention:
    return Attention(c, c // head_dim, head_dim, qkv_bias=True, residual_connection=True,
                     norm_num_groups=32, eps=1e-6)


class _EncoderDown(nn.Module):
    def __init__(self, cin, cout, layers, downsample):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(cin if i == 0 else cout, cout, None, 1e-6) for i in range(layers)])
        self.downsamplers = (nn.ModuleList([Downsample2D(cout, cout, vae=True)])
                             if downsample else None)

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        return self.downsamplers[0](x) if self.downsamplers is not None else x


class _EncoderMid(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(c, c, None, 1e-6) for _ in range(2)])
        self.attentions = nn.ModuleList([_vae_attention(c, c)])

    def forward(self, x):
        return self.resnets[1](_attend(self.attentions[0], self.resnets[0](x)))


class Encoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        chans = cfg["block_out_channels"]
        self.conv_in = nn.Conv2d(cfg["in_channels"], chans[0], 3, padding=1)
        blocks, cout = [], chans[0]
        for i, c in enumerate(chans):
            blocks.append(_EncoderDown(cout, c, cfg["layers_per_block"], i != len(chans) - 1))
            cout = c
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _EncoderMid(cout)
        self.conv_norm_out = GroupNorm(32, cout, 1e-6, act="silu")
        self.conv_out = nn.Conv2d(cout, 2 * cfg["latent_channels"], 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        return self.conv_out(self.conv_norm_out(self.mid_block(x)))


def _vae_st_resnet(cin, cout):
    return SpatioTemporalResBlock(cin, cout, None, eps=1e-6, merge=0.0)


class _DecoderMid(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.resnets = nn.ModuleList([_vae_st_resnet(c, c) for _ in range(2)])
        self.attentions = nn.ModuleList([_vae_attention(c, c)])

    def forward(self, x, frames):
        x = self.resnets[0](x, None, frames)
        return self.resnets[1](_attend(self.attentions[0], x), None, frames)


class _DecoderUp(nn.Module):
    def __init__(self, cin, cout, layers, upsample):
        super().__init__()
        self.resnets = nn.ModuleList(
            [_vae_st_resnet(cin if i == 0 else cout, cout) for i in range(layers)])
        self.upsamplers = nn.ModuleList([Upsample2D(cout, cout)]) if upsample else None

    def forward(self, x, frames):
        for r in self.resnets:
            x = r(x, None, frames)
        return self.upsamplers[0](x) if self.upsamplers is not None else x


class TemporalDecoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        chans = cfg["block_out_channels"]
        self.conv_in = nn.Conv2d(cfg["latent_channels"], chans[-1], 3, padding=1)
        self.mid_block = _DecoderMid(chans[-1])
        rev, blocks, c = chans[::-1], [], chans[-1]
        for i, cout in enumerate(rev):
            blocks.append(_DecoderUp(c, cout, cfg["layers_per_block"] + 1, i != len(rev) - 1))
            c = cout
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = GroupNorm(32, chans[0], 1e-6, act="silu")
        self.conv_out = nn.Conv2d(chans[0], cfg["out_channels"], 3, padding=1)
        self.time_conv_out = nn.Conv3d(cfg["out_channels"], cfg["out_channels"], (3, 1, 1),
                                       padding=(1, 0, 0))

    def forward(self, z, frames: int):
        """z (B*F, 4, h, w), the frames of one clip mixed together -> (B*F, 3, H, W)."""
        x = self.mid_block(self.conv_in(z), frames)
        for block in self.up_blocks:
            x = block(x, frames)
        x = self.conv_out(self.conv_norm_out(x))
        bf, c, h, w = x.shape
        xt = self.time_conv_out(x.reshape(bf // frames, frames, c, h, w).permute(0, 2, 1, 3, 4))
        return xt.permute(0, 2, 1, 3, 4).reshape(bf, c, h, w)


class AutoencoderKLTemporalDecoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg["latent_channels"], 2 * cfg["latent_channels"], 1)
        self.decoder = TemporalDecoder(cfg)

    def encode_moments(self, x):
        """(B, H, W, 3) -> (B, h, w, 8): mean, then log-variance."""
        return self.quant_conv(self.encoder(x.float().permute(0, 3, 1, 2))).permute(0, 2, 3, 1)

    def encode(self, x):
        """The latent distribution's mode (its mean), unscaled."""
        return self.encode_moments(x)[..., :self.cfg["latent_channels"]]

    def decode(self, z, frames: int):
        """(B*F, h, w, 4) -> (B*F, H, W, 3)."""
        return self.decoder(z.float().permute(0, 3, 1, 2), frames).permute(0, 2, 3, 1)


# ---- CLIP ViT-H/14 image encoder ----

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class CLIPAttention(nn.Module):
    def __init__(self, c: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = nn.Linear(c, c), nn.Linear(c, c)
        self.v_proj, self.out_proj = nn.Linear(c, c), nn.Linear(c, c)

    def forward(self, x):
        q, k, v = (split_heads(p(x), self.heads) for p in (self.q_proj, self.k_proj, self.v_proj))
        d = x.shape[-1] // self.heads
        return self.out_proj(merge_heads(attention(q, k, v, d ** -0.5), self.heads))


class CLIPMLP(nn.Module):
    def __init__(self, c: int, inner: int):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(c, inner), nn.Linear(inner, c)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        c, eps = cfg["hidden_size"], cfg["layer_norm_eps"]
        self.self_attn = CLIPAttention(c, cfg["num_attention_heads"])
        self.layer_norm1 = LayerNorm(c, eps)
        self.mlp = CLIPMLP(c, cfg["intermediate_size"])
        self.layer_norm2 = LayerNorm(c, eps)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg) for _ in range(cfg["num_hidden_layers"])])


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        c, p = cfg["hidden_size"], cfg["patch_size"]
        self.class_embedding = nn.Parameter(torch.zeros(c))
        self.patch_embedding = nn.Conv2d(3, c, p, stride=p, bias=False)
        self.position_embedding = nn.Embedding((cfg["image_size"] // p) ** 2 + 1, c)

    def forward(self, pixels):
        patches = self.patch_embedding(pixels).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(patches.shape[0], 1, -1)
        return torch.cat([cls, patches], dim=1) + self.position_embedding.weight[None]


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        c, eps = cfg["hidden_size"], cfg["layer_norm_eps"]
        self.embeddings = CLIPEmbeddings(cfg)
        self.pre_layrnorm = LayerNorm(c, eps)
        self.encoder = CLIPEncoder(cfg)
        self.post_layernorm = LayerNorm(c, eps)

    def forward(self, pixels):
        x = self.pre_layrnorm(self.embeddings(pixels))
        for layer in self.encoder.layers:
            x = layer(x)
        return self.post_layernorm(x[:, 0])


class CLIPVisionModelWithProjection(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        self.vision_model = CLIPVisionTransformer(cfg)
        self.visual_projection = nn.Linear(cfg["hidden_size"], cfg["projection_dim"], bias=False)

    def forward(self, images):
        """[-1, 1] (B, H, W, 3) frames -> (B, projection_dim) image embeddings."""
        pixels = clip_preprocess(images, self.cfg["image_size"])
        return self.visual_projection(self.vision_model(pixels.permute(0, 3, 1, 2)))


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of an antialiased Keys-cubic resize (a = -0.5),
    the kernel widened by n_in / n_out on a downscale: the resize SVD's
    CLIP preprocessing applies."""
    if n_in == n_out:
        return np.eye(n_in)
    inv = n_in / n_out
    width = max(inv, 1.0)
    centres = (np.arange(n_out) + 0.5) * inv - 0.5
    w = _keys_cubic(np.abs(centres[None, :] - np.arange(n_in)[:, None]) / width)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1e-9, w / np.where(total != 0, total, 1.0), 0.0)
    inside = (centres >= -0.5) & (centres <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def clip_preprocess(images, size: int):
    """[-1, 1] (B, H, W, 3) -> CLIP-normalised (B, size, size, 3)."""
    _, h, w, _ = images.shape
    wh = torch.as_tensor(resize_weights(h, size), dtype=torch.float32, device=images.device)
    ww = torch.as_tensor(resize_weights(w, size), dtype=torch.float32, device=images.device)
    out = torch.einsum("bhwc,hy,wx->byxc", images.float(), wh, ww)
    out = torch.clamp((out + 1.0) * 0.5, 0.0, 1.0)
    mean = torch.tensor(CLIP_MEAN, device=images.device)
    std = torch.tensor(CLIP_STD, device=images.device)
    return (out - mean) / std
