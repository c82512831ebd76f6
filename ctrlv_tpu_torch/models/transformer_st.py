"""TransformerSpatioTemporalModel: paired spatial and temporal attention.

Counterpart of ``ctrlv_tpu/models/transformer_st.py`` with both of its
temporal layouts:

- "seq" (the default): the temporal block runs on (B*S, F, C), reached from
  the (B*F, S, C) token layout by a transpose pair in device memory;
- "frames_major": the temporal block stays in (B*F, S, C) and its frame
  attention takes the frames-major kernel (``ops/mha.py``), so the
  transpose pair never exists.

The two compute the same function from the same weights.
``temporal_layout`` is a plain attribute and may be set on a built model.

Under a frame shard (``parallel/frames.py``) the spatial blocks run on this
rank's frames; each temporal block gathers the frames over the frame group,
runs on all of them and keeps its own. The frame position ids are the
global frame indices.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..parallel.frames import current_frame_shard
from .layers import (
    AlphaBlender,
    BasicTransformerBlock,
    GroupNorm,
    TemporalBasicTransformerBlock,
    TimestepEmbedding,
    get_timestep_embedding,
)


class TransformerSpatioTemporalModel(nn.Module):
    def __init__(
        self,
        num_attention_heads: int,
        attention_head_dim: int,
        in_channels: int,
        num_layers: int = 1,
        cross_attention_dim: Optional[int] = 1024,
        temporal_layout: str = "seq",
    ):
        super().__init__()
        if temporal_layout not in ("seq", "frames_major"):
            raise ValueError(f"temporal_layout {temporal_layout!r}")
        self.temporal_layout = temporal_layout
        inner = num_attention_heads * attention_head_dim
        self.in_channels = in_channels
        self.norm = GroupNorm(32, in_channels, 1e-6)
        self.proj_in = nn.Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList(
            [
                BasicTransformerBlock(
                    inner, num_attention_heads, attention_head_dim, cross_attention_dim
                )
                for _ in range(num_layers)
            ]
        )
        self.temporal_transformer_blocks = nn.ModuleList(
            [
                TemporalBasicTransformerBlock(
                    inner, num_attention_heads, attention_head_dim, cross_attention_dim
                )
                for _ in range(num_layers)
            ]
        )
        self.time_pos_embed = TimestepEmbedding(in_channels, in_channels * 4, out_dim=in_channels)
        self.time_mixer = AlphaBlender(0.5, "learned_with_images")
        self.proj_out = nn.Linear(inner, in_channels)

    def forward(self, hidden_states, encoder_hidden_states, image_only_indicator):
        """hidden_states (B*F, C, H, W); encoder_hidden_states (B*F, T, cross);
        image_only_indicator (B, F). Under a frame shard the first two hold
        this rank's frames only and the indicator all F."""
        bf, channels, height, width = hidden_states.shape
        batch, num_frames = image_only_indicator.shape
        shard = current_frame_shard()
        first, last = (0, num_frames) if shard is None else (shard.lo, shard.hi)
        seq = height * width

        # Temporal cross-attention context: the first frame's tokens, batched
        # as the temporal block's input is: one copy per frame, (B*F, T, cross),
        # when frames-major, else one per pixel, (B*S, T, cross). Every frame
        # carries the same CLIP context, so a shard's first frame serves.
        fm = self.temporal_layout == "frames_major"
        tokens = encoder_hidden_states.shape[-2]
        tc = encoder_hidden_states.reshape(batch, last - first, tokens, -1)[:, :1]
        copies = num_frames if fm else seq
        time_context = tc.expand(batch, copies, tokens, tc.shape[-1]).reshape(
            batch * copies, tokens, -1
        )

        residual = hidden_states
        h = self.norm(hidden_states)
        h = h.permute(0, 2, 3, 1).reshape(bf, seq, channels)
        h = self.proj_in(h)
        inner = h.shape[-1]

        frame_ids = torch.arange(first, last, device=h.device).repeat(batch)
        t_emb = get_timestep_embedding(frame_ids, self.in_channels)
        emb = self.time_pos_embed(t_emb.to(h.dtype))[:, None, :]  # (B*F, 1, C)
        if shard is not None:
            image_only_indicator = shard.local_frames(image_only_indicator)

        for block, tblock in zip(self.transformer_blocks, self.temporal_transformer_blocks):
            h = block(h, encoder_hidden_states)
            h_mix = h + emb
            if shard is not None:
                h_mix = shard.gather(h_mix, batch)
            if fm:
                h_mix = tblock(h_mix, time_context, frames_major=num_frames)
            else:
                h_mix = (
                    h_mix.reshape(batch, num_frames, seq, inner)
                    .transpose(1, 2)
                    .reshape(batch * seq, num_frames, inner)
                    .contiguous()  # at batch 1 the reshape is a strided view, no copy
                )
                h_mix = tblock(h_mix, time_context)
                h_mix = (
                    h_mix.reshape(batch, seq, num_frames, inner)
                    .transpose(1, 2)
                    .reshape(batch * num_frames, seq, inner)
                    .contiguous()
                )
            if shard is not None:
                h_mix = shard.take(h_mix, batch)
            h = self.time_mixer(h, h_mix, image_only_indicator)

        h = self.proj_out(h)
        h = h.reshape(bf, height, width, channels).permute(0, 3, 1, 2)
        # The residual comes first, so that the sum takes its contiguous NCHW
        # layout and not the permuted view's.
        return residual + h
