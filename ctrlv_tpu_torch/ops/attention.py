"""Attention over (B, S, H, D) ("BSHD") operands: the plain version and the
one-pass kernel, with the JAX package's implementation switch.

Counterpart of ``ctrlv_tpu/ops/attention.py`` and
``ctrlv_tpu/ops/flash_attention.py``. ``dot_product_attention`` serves every
attention that ``models.layers.Attention`` does not route to a kernel of
``ops/mha.py``: the spatial self-attention at 640 and 160 tokens, the VAE
mid-block attention, CLIP.

``flash_attention`` replaces the Pallas kernel
``ctrlv_tpu/ops/flash_attention.py::flash_attention``. A contiguous
(B, S, H, D) tensor is the (B, S, H*D) tensor that ``csrc/mha.cu`` reads, so
the TPU kernel's transpose to (B*H, S, D) has no counterpart: the wrapper
launches the flash-style kernel of that source through an entry point of its
own, with tiles sized for a few hundred tokens. It counts its launches as
``LAUNCHES["flash"]``.

The switch keeps the JAX package's names:

- ``"xla"``: the library's attention (``library_attention``: SDPA on the
  card, the plain version on the CPU), here and at the three sites of
  ``models.layers.Attention`` that would take a kernel of ``ops/mha.py``, as
  the JAX package sends all four to XLA's attention;
- ``"pallas"``: the hand-written kernel wherever its gate passes;
- ``"auto"`` (the default): the kernel where its gate passes and the H100's
  A/B of the full-width denoise step found it no slower (PERF.md).

A CPU tensor always takes the plain version. On a CUDA tensor whose shape
passes the gate the kernel launches or raises. The switch governs this
module and, through ``models.layers.Attention``, the kernels of
``ops/mha.py``; ``plain_kernels`` switches every kernel to its plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._launch import check_operand, check_tma_operands, launch, plain_selected, with_recompute

_ATTENTION_IMPL = "auto"


def set_attention_impl(impl: str) -> None:
    global _ATTENTION_IMPL
    if impl not in ("auto", "xla", "pallas"):
        raise ValueError(f"attention impl {impl!r} is not 'auto', 'xla' or 'pallas'")
    _ATTENTION_IMPL = impl


def get_attention_impl() -> str:
    return _ATTENTION_IMPL


def flash_supported(sq: int, sk: int, head_dim: int, dtype=torch.bfloat16) -> bool:
    """Gate of the kernel (``_pallas_supported`` in the JAX package), a pure
    function of shape and dtype."""
    return head_dim in (64, 128) and sk >= 128 and sq >= 128 and dtype == torch.bfloat16


def flash_attention_plain(q, k, v, scale: float):
    """f32 logits and softmax, weights cast to the input dtype before the
    product with V; (B, S, H, D) in and out."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def _check_flash(q, k, v) -> tuple[int, int, int, int, int]:
    """Validate the kernel's operands; returns (B, Sq, Sk, H, D)."""
    for t in (q, k, v):
        check_operand("flash", t, torch.bfloat16, q.device)
        if t.dim() != 4:
            raise ValueError(f"flash: operands must be (B, S, H, D), got {tuple(t.shape)}")
    b, sq, heads, d = q.shape
    sk = k.shape[1]
    if k.shape != v.shape or k.shape != (b, sk, heads, d):
        raise ValueError(f"flash: shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if d not in (64, 128):
        raise ValueError(f"flash: head dim {d} is not 64 or 128")
    check_tma_operands("flash", heads * d, q, k, v)  # (B, S, H*D) rows, as csrc/mha.cu reads them
    return b, sq, sk, heads, d


def flash_attention(q, k, v, scale: float):
    """softmax(q k^T * scale) v per head over (B, Sq, H, D) x (B, Sk, H, D)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    b, sq, sk, heads, d = _check_flash(q, k, v)

    def run(q, k, v):
        out = torch.empty_like(q)
        launch(
            "flash", "ctrlv_flash_fwd", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, sk, heads, d, ctypes.c_float(scale),
        )
        return out

    # a gradient recomputes through the plain version, as the JAX package's does
    return with_recompute(run, lambda q, k, v: flash_attention_plain(q, k, v, scale), q, k, v)


def library_attention(q, k, v, scale: float):
    """The counterpart of XLA's attention that ``"xla"`` selects: PyTorch's
    ``scaled_dot_product_attention`` on a CUDA tensor, the plain version on
    the CPU; (B, S, H, D) in and out."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    out = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale)
    return out.transpose(1, 2)


def dot_product_attention(q, k, v, scale: Optional[float] = None):
    """Unmasked multi-head attention, (B, S, H, D) in and out."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if plain_selected():
        return flash_attention_plain(q, k, v, scale)
    if _ATTENTION_IMPL == "xla":
        return library_attention(q, k, v, scale)
    # On the H100 the kernel made the full-width step faster (PERF.md, step
    # A/B), so "auto" takes it wherever its gate passes, as "pallas" does.
    if flash_supported(q.shape[1], k.shape[1], q.shape[-1], q.dtype):
        return flash_attention(q, k, v, scale)
    return flash_attention_plain(q, k, v, scale)
