"""BBOXFrameAttention: a rezero transformer producing per-frame conditioning latents.

Counterpart of ``ctrlv_tpu/models/bbox_attention.py``: a continuous-input
transformer over the first frame latent's pixels: GroupNorm(4, eps 1e-6)
and a 1x1 ``proj_in``, N ``BasicTransformerBlock``s (heads = num_frames,
head dim = out_channels, cross-attention to object tokens where
``cross_attention_dim`` is given), a 1x1 ``proj_out``, and the rezero scalar
``rz_weight`` (initialised to 0), so that the module starts as an exact
channel repeat of its input: out = h * rz_weight + repeat(x, out / in).

Input and output are NCHW. The JAX module's ``jnp.tile(x, (1, 1, 1, r))``
on NHWC repeats the whole channel block r times, which in NCHW is
``x.repeat(1, r, 1, 1)`` (not ``repeat_interleave``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .layers import BasicTransformerBlock, GroupNorm


class BBOXFrameAttention(nn.Module):
    def __init__(self, num_frames: int, in_channels: int = 4, out_channels: int = 4,
                 num_layers: int = 2, cross_attention_dim: Optional[int] = None,
                 norm_num_groups: int = 4):
        super().__init__()
        inner = num_frames * out_channels
        self.in_channels, self.out_channels = in_channels, out_channels
        self.norm = GroupNorm(norm_num_groups, in_channels, 1e-6)
        self.proj_in = nn.Conv2d(in_channels, inner, 1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, num_frames, out_channels, cross_attention_dim)
            for _ in range(num_layers))
        self.proj_out = nn.Conv2d(inner, out_channels, 1)
        self.rz_weight = nn.Parameter(torch.zeros(1))

    def forward(self, image_latents: torch.Tensor,
                bbox_tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, C_in, h, w) [+ (B, T, D) tokens] -> (B, out_channels, h, w)."""
        dtype = self.proj_in.weight.dtype
        residual = image_latents.to(dtype).contiguous()
        b, _, h, w = residual.shape
        x = self.proj_in(self.norm(residual))
        inner = x.shape[1]
        x = x.permute(0, 2, 3, 1).reshape(b, h * w, inner)
        for block in self.transformer_blocks:
            x = block(x, bbox_tokens)
        x = x.reshape(b, h, w, inner).permute(0, 3, 1, 2)
        x = self.proj_out(x)
        repeat = self.out_channels // self.in_channels
        return x * self.rz_weight.to(x.dtype) + residual.repeat(1, repeat, 1, 1)
