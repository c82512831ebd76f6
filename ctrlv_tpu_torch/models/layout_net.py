"""LayoutNet: a GPT-2 causal transformer over flattened layout vectors.

Counterpart of ``ctrlv_tpu/models/layout_net.py``: a linear in-projection
(n_layout + n_cond -> n_embd, no bias), a GPT-2 trunk (learned positions,
pre-LN blocks, the tanh "gelu_new" MLP, the causal mask filled with -1e9), a
linear out-projection (n_embd -> n_layout, no bias) and the MSE next-token
loss over shifted sequences.

Parameter names are the JAX module's after ``convert.py``: ``layout_in``,
``wpe`` (a raw (n_positions, n_embd) parameter), ``h.{i}.ln_1``,
``h.{i}.c_attn``, ``h.{i}.c_proj``, ``h.{i}.ln_2``, ``h.{i}.mlp_c_fc``,
``h.{i}.mlp_c_proj``, ``ln_f``, ``layout_out``; the converter keeps GPT-2's
``ln_1`` and ``ln_2`` whole. The projections are ``nn.Linear`` (out, in), not
transformers' ``Conv1D``. The norms are the port's LayerNorm: the kernel in
bf16, the plain version in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import LayerNorm


@dataclasses.dataclass(frozen=True)
class LayoutNetConfig:
    n_layout: int = 1024
    n_cond: int = 1024  # extra conditioning channels appended to layout
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5

    @classmethod
    def tiny(cls) -> "LayoutNetConfig":
        return cls(n_layout=16, n_cond=8, n_positions=32, n_embd=32, n_layer=2, n_head=2)


class GPT2Block(nn.Module):
    def __init__(self, config: LayoutNetConfig):
        super().__init__()
        c = config.n_embd
        self.n_head = config.n_head
        self.ln_1 = LayerNorm(c, config.layer_norm_epsilon)
        self.c_attn = nn.Linear(c, 3 * c)
        self.c_proj = nn.Linear(c, c)
        self.ln_2 = LayerNorm(c, config.layer_norm_epsilon)
        self.mlp_c_fc = nn.Linear(c, 4 * c)
        self.mlp_c_proj = nn.Linear(4 * c, c)

    def forward(self, x):
        b, s, c = x.shape
        head_dim = c // self.n_head
        q, k, v = self.c_attn(self.ln_1(x)).split(c, dim=-1)
        q, k, v = (t.reshape(b, s, self.n_head, head_dim) for t in (q, k, v))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * head_dim**-0.5
        mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        logits = torch.where(mask, logits, torch.full_like(logits, -1e9))
        weights = torch.exp(logits - logits.amax(-1, keepdim=True))
        weights = weights / weights.sum(-1, keepdim=True)
        attn = torch.einsum("bhqk,bkhd->bqhd", weights.to(x.dtype), v).reshape(b, s, c)
        x = x + self.c_proj(attn)
        h = self.mlp_c_proj(F.gelu(self.mlp_c_fc(self.ln_2(x)), approximate="tanh"))
        return x + h


class LayoutNet(nn.Module):
    def __init__(self, config: LayoutNetConfig = LayoutNetConfig()):
        super().__init__()
        self.config = config
        self.layout_in = nn.Linear(config.n_layout + config.n_cond, config.n_embd, bias=False)
        self.wpe = nn.Parameter(0.02 * torch.randn(config.n_positions, config.n_embd))
        self.h = nn.ModuleList(GPT2Block(config) for _ in range(config.n_layer))
        self.ln_f = LayerNorm(config.n_embd, config.layer_norm_epsilon)
        self.layout_out = nn.Linear(config.n_embd, config.n_layout, bias=False)

    def forward(self, inputs_embeds: torch.Tensor, labels: Optional[torch.Tensor] = None):
        """(B, S, n_layout + n_cond) -> (prediction (B, S, n_layout), loss or None)."""
        dtype = self.layout_in.weight.dtype
        s = inputs_embeds.shape[1]
        x = self.layout_in(inputs_embeds.to(dtype)) + self.wpe[None, :s].to(dtype)
        for block in self.h:
            x = block(x)
        pred = self.layout_out(self.ln_f(x))
        loss = None
        if labels is not None:
            loss = torch.mean((pred[:, :-1].float() - labels[:, 1:].float()) ** 2)
        return pred, loss
