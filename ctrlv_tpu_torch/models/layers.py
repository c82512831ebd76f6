"""Core building blocks of the SVD spatio-temporal architecture.

Counterpart of ``ctrlv_tpu/models/layers.py``. Parameter names are the
diffusers ones (``to_q``, ``to_out.0``, ``net.0.proj``, ``norm1`` ...), so
``load_state_dict(strict=True)`` takes converted JAX params or diffusers
weights alike. Convolutional inputs are NCHW inside the port; the token
layers take (B, S, C).

Numerics follow the JAX package: norms compute their statistics in f32 and
return the input dtype, matmuls and convs run in the parameters' dtype.

GroupNorm and LayerNorm are the kernels of ``ops/group_norm.py`` and
``ops/layer_norm.py`` (the JAX package's ``FusedGroupNorm`` and
``FusedLayerNorm``, which compute what its ``GroupNorm`` and
``nn.LayerNorm`` compute); Attention routes to the kernels of ``ops/mha.py``
and ``ops/attention.py``; FeedForward routes to the fused kernel of
``ops/geglu_ff.py`` where ``set_fused_geglu_ff`` and the shape gate allow.
``plain_kernels()`` sends them all to their plain versions.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import mha
from ..ops.attention import dot_product_attention, get_attention_impl
from ..ops.geglu_ff import geglu_ff, geglu_ff_plain, geglu_ff_supported, gelu_erf
from ..ops.group_norm import group_norm, group_norm_plain
from ..ops.layer_norm import layer_norm, layer_norm_plain


class GroupNorm(nn.Module):
    """GroupNorm over (B, C, *spatial), contiguous, with f32 statistics and
    an optional fused activation (``act="silu"``); returns x's dtype."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6,
                 act: Optional[str] = None):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.act = act
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        fn = group_norm_plain if mha.plain_selected() else group_norm
        return fn(x, self.weight, self.bias, self.num_groups, self.eps, self.act)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with f32 statistics; returns x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        fn = layer_norm_plain if mha.plain_selected() else layer_norm
        return fn(x, self.weight, self.bias, self.eps)


def get_timestep_embedding(
    timesteps,
    embedding_dim: int,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: float = 10000.0,
):
    """Sinusoidal embeddings (diffusers ``Timesteps``), always in f32."""
    timesteps = timesteps.float()
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device
    )
    emb = torch.exp(exponent / (half_dim - downscale_freq_shift))
    emb = timesteps[:, None] * emb[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


class TimestepEmbedding(nn.Module):
    """Two-layer SiLU MLP lifting a sinusoidal embedding."""

    def __init__(self, in_channels: int, time_embed_dim: int, out_dim: Optional[int] = None):
        super().__init__()
        self.linear_1 = nn.Linear(in_channels, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, out_dim or time_embed_dim)

    def forward(self, sample):
        return self.linear_2(F.silu(self.linear_1(sample)))


class AlphaBlender(nn.Module):
    """x = a * spatial + (1 - a) * temporal with a = sigmoid(mix_factor).

    "learned_with_images" forces a to 1 on frames flagged by
    image_only_indicator (the UNet); "learned" ignores it (the VAE decoder).
    switch_spatial_to_temporal_mix swaps the roles (the ResBlocks).
    """

    def __init__(
        self,
        alpha: float = 0.5,
        merge_strategy: str = "learned_with_images",
        switch_spatial_to_temporal_mix: bool = False,
    ):
        super().__init__()
        if merge_strategy not in ("learned", "learned_with_images"):
            raise ValueError(merge_strategy)
        self.merge_strategy = merge_strategy
        self.switch_spatial_to_temporal_mix = switch_spatial_to_temporal_mix
        self.mix_factor = nn.Parameter(torch.tensor([alpha], dtype=torch.float32))

    def forward(self, x_spatial, x_temporal, image_only_indicator=None):
        alpha = torch.sigmoid(self.mix_factor.float())[0]
        if self.merge_strategy == "learned_with_images":
            is_image = image_only_indicator.reshape(-1).bool()
            alpha = torch.where(is_image, torch.ones_like(alpha), alpha)
            alpha = alpha.reshape((-1,) + (1,) * (x_spatial.dim() - 1))
        alpha = alpha.to(x_spatial.dtype)
        if self.switch_spatial_to_temporal_mix:
            alpha = 1.0 - alpha
        return alpha * x_spatial + (1.0 - alpha) * x_temporal


class Attention(nn.Module):
    """Multi-head attention with diffusers' ``Attention`` semantics.

    Input (B, S, C); optional context (B, T, C_ctx) for cross-attention.
    Self-attention routes to the kernels of ``ops/mha.py`` at the same call
    sites as the JAX package: the spatial kernel at S, Sk >= 1024, the
    temporal kernel at few frames over many rows, the frames-major temporal
    kernel when ``temporal_frames`` is given. Everything else goes to
    ``ops.attention.dot_product_attention``, whose switch decides between
    the one-pass kernel and the plain version. Under ``"xla"`` the three
    sites go there too, as in the JAX package, and so to the library's
    attention.
    """

    def __init__(
        self,
        query_dim: int,
        heads: int = 8,
        dim_head: int = 64,
        cross_attention_dim: Optional[int] = None,
        qkv_bias: bool = False,
        out_bias: bool = True,
        residual_connection: bool = False,
        norm_num_groups: Optional[int] = None,
        eps: float = 1e-5,
    ):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.dim_head = dim_head
        self.query_dim = query_dim
        self.residual_connection = residual_connection
        if norm_num_groups is not None:
            self.group_norm = GroupNorm(norm_num_groups, query_dim, eps)
        else:
            self.group_norm = None
        ctx_dim = cross_attention_dim or query_dim
        self.to_q = nn.Linear(query_dim, inner, bias=qkv_bias)
        self.to_k = nn.Linear(ctx_dim, inner, bias=qkv_bias)
        self.to_v = nn.Linear(ctx_dim, inner, bias=qkv_bias)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim, bias=out_bias)])

    def forward(self, hidden_states, context=None, temporal_frames: Optional[int] = None):
        """``temporal_frames=F`` marks frames-major temporal self-attention:
        hidden_states is (B*F, S, C) and attention runs over the F frames of
        each pixel, in that layout."""
        residual = hidden_states
        if self.group_norm is not None:
            channels_first = hidden_states.transpose(1, 2).contiguous()
            hidden_states = self.group_norm(channels_first).transpose(1, 2)
        b, sq = hidden_states.shape[:2]

        if context is not None and context.shape[1] == 1:
            # Cross-attention to one token: the softmax over one key is 1,
            # so the block is exactly broadcast(to_out(to_v(ctx))).
            out = self.to_out[0](self.to_v(context)).expand(b, sq, self.query_dim)
            return out + residual if self.residual_connection else out

        ctx = hidden_states if context is None else context
        q = self.to_q(hidden_states)
        k = self.to_k(ctx)
        v = self.to_v(ctx)
        sk = k.shape[1]
        inner = self.heads * self.dim_head
        scale = self.dim_head**-0.5
        plain = mha.plain_selected()
        kernels = get_attention_impl() != "xla"
        if temporal_frames is not None:
            if context is not None:
                raise ValueError("frames-major temporal attention is self-attention")
            if not kernels:
                out = self._frames_major_library(q, k, v, temporal_frames, scale)
            elif not plain and mha.small_mha_fm_supported(b, sq, inner, self.heads,
                                                          temporal_frames):
                out = mha.small_mha_attention_fm(q, k, v, self.heads, scale, temporal_frames)
            else:
                out = mha.small_mha_attention_fm_plain(
                    q, k, v, self.heads, scale, temporal_frames
                )
        elif kernels and mha.mha_supported(sq, sk, inner, self.heads):
            fn = mha.mha_attention_plain if plain else mha.mha_attention
            out = fn(q, k, v, self.heads, scale)
        elif kernels and mha.small_mha_supported(b, sq, sk, inner, self.heads):
            fn = mha.small_mha_attention_plain if plain else mha.small_mha_attention
            out = fn(q, k, v, self.heads, scale)
        else:
            shape = (b, -1, self.heads, self.dim_head)
            out = dot_product_attention(
                q.reshape(shape), k.reshape(shape), v.reshape(shape), scale
            ).reshape(b, sq, inner)
        out = self.to_out[0](out)
        return out + residual if self.residual_connection else out

    def _frames_major_library(self, q, k, v, frames: int, scale: float):
        """Attention over the F frames of each pixel of (B*F, S, H*D)
        operands through ``dot_product_attention``: to (B*S, F, H, D) and
        back (the JAX package's ``xla_fm_attention``)."""
        bf, s, inner = q.shape
        b = bf // frames

        def to_bshd(x):
            return x.reshape(b, frames, s, inner).transpose(1, 2).reshape(
                b * s, frames, self.heads, self.dim_head)

        out = dot_product_attention(to_bshd(q), to_bshd(k), to_bshd(v), scale)
        return out.reshape(b, s, frames, inner).transpose(1, 2).reshape(bf, s, inner)


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * gelu_erf(gate)


class FeedForward(nn.Module):
    """diffusers FeedForward: GEGLU (``net.0``) then Linear (``net.2``).

    While ``set_fused_geglu_ff`` is on and the flattened (rows, C) shape
    passes ``geglu_ff_supported``, the whole chain is one call of the fused
    kernel on the same parameters, as in the JAX package; otherwise the two
    Linears with the gelu gate between. Where autograd wants a gradient of
    the call (of x or of a parameter), the two Linears run, unlike in the
    JAX package: the kernel's backward would recompute through them, so the
    kernel would only add its own time (PERF.md)."""

    def __init__(self, dim: int, dim_out: Optional[int] = None, mult: int = 4):
        super().__init__()
        inner = dim * mult
        # net.1 is diffusers' dropout, which has no parameters
        self.net = nn.ModuleList(
            [GEGLU(dim, inner), nn.Identity(), nn.Linear(inner, dim_out or dim)]
        )

    def forward(self, x):
        proj, out = self.net[0].proj, self.net[2]
        c_in = x.shape[-1]
        m = x.numel() // c_in
        wants_grad = torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters()))
        if not wants_grad and geglu_ff_supported(m, c_in, out.in_features, out.out_features,
                                                 x.dtype):
            fn = geglu_ff_plain if mha.plain_selected() else geglu_ff
            y = fn(x.reshape(m, c_in), proj.weight, proj.bias, out.weight, out.bias)
            return y.reshape(x.shape[:-1] + (out.out_features,))
        for layer in self.net:
            x = layer(x)
        return x


class BasicTransformerBlock(nn.Module):
    """Pre-LN block: self-attention, cross-attention, GEGLU feed-forward.
    LayerNorm eps is 1e-5, as in diffusers."""

    def __init__(self, dim: int, heads: int, dim_head: int, cross_attention_dim=None):
        super().__init__()
        self.norm1 = LayerNorm(dim, 1e-5)
        self.attn1 = Attention(dim, heads, dim_head)
        if cross_attention_dim is not None:
            self.norm2 = LayerNorm(dim, 1e-5)
            self.attn2 = Attention(dim, heads, dim_head, cross_attention_dim=cross_attention_dim)
        else:
            self.norm2 = self.attn2 = None
        self.norm3 = LayerNorm(dim, 1e-5)
        self.ff = FeedForward(dim)

    def forward(self, hidden_states, encoder_hidden_states=None):
        hidden_states = self.attn1(self.norm1(hidden_states)) + hidden_states
        if self.attn2 is not None:
            hidden_states = (
                self.attn2(self.norm2(hidden_states), encoder_hidden_states) + hidden_states
            )
        return self.ff(self.norm3(hidden_states)) + hidden_states


class TemporalBasicTransformerBlock(nn.Module):
    """Transformer block over the frame axis: input (B*S, F, C), pixels
    batched and frames as the sequence. ff_in with residual, self-attention
    over frames, cross-attention to the first frame's CLIP token, FF.

    With ``frames_major=F`` the input is (B*F, S, C) instead, the UNet's own
    layout. The norms, the feed-forwards and the cross-attention work on the
    last axis and do not care; only the self-attention needs the frame axis
    and takes the frames-major kernel. ``encoder_hidden_states`` is then
    batched (B*F, ...).
    """

    def __init__(self, dim: int, heads: int, dim_head: int, cross_attention_dim=None):
        super().__init__()
        self.norm_in = LayerNorm(dim, 1e-5)
        self.ff_in = FeedForward(dim)
        self.norm1 = LayerNorm(dim, 1e-5)
        self.attn1 = Attention(dim, heads, dim_head)
        if cross_attention_dim is not None:
            self.norm2 = LayerNorm(dim, 1e-5)
            self.attn2 = Attention(dim, heads, dim_head, cross_attention_dim=cross_attention_dim)
        else:
            self.norm2 = self.attn2 = None
        self.norm3 = LayerNorm(dim, 1e-5)
        self.ff = FeedForward(dim)

    def forward(self, hidden_states, encoder_hidden_states=None,
                frames_major: Optional[int] = None):
        hidden_states = self.ff_in(self.norm_in(hidden_states)) + hidden_states
        hidden_states = (
            self.attn1(self.norm1(hidden_states), temporal_frames=frames_major) + hidden_states
        )
        if self.attn2 is not None:
            hidden_states = (
                self.attn2(self.norm2(hidden_states), encoder_hidden_states) + hidden_states
            )
        return self.ff(self.norm3(hidden_states)) + hidden_states


class Downsample2D(nn.Module):
    """3x3 stride-2 conv, padding 1 (UNet)."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, out_channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class DownsampleVAE2D(nn.Module):
    """VAE encoder: pad right and bottom by one, then 3x3 stride-2 conv."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, out_channels, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample2D(nn.Module):
    """2x nearest upsample, then 3x3 conv."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, out_channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))
