"""Plain attention over (B, S, H, D) ("BSHD") operands.

The counterpart of ``ctrlv_tpu/ops/attention.py::_xla_attention``: f32
logits and softmax, weights cast to the input dtype before the product with
V. It serves every attention that is not routed to a kernel of
``ops/mha.py``: the VAE mid-block attention, CLIP, and the spatial
attention at 640 tokens and fewer. The JAX package's flash kernel
(``ops/flash_attention.py``) is off its default path and has no counterpart
here yet.
"""

from __future__ import annotations

from typing import Optional

import torch


def dot_product_attention(q, k, v, scale: Optional[float] = None):
    """Unmasked multi-head attention, (B, S, H, D) in and out."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)
