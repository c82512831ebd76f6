"""Multi-head attention over (B, S, H*D) tensors, heads packed in the last axis.

The operands are exactly what the Q/K/V linear layers emit; no head-major
copy is made. Two kernels, each a CUDA C++ kernel for Hopper (sm_90a) with
its plain PyTorch version beside it:

- ``mha_attention`` (``csrc/mha.cu``) replaces the Pallas kernel
  ``ctrlv_tpu/ops/mha.py::mha_attention``: the spatial self-attention at the
  2560-token level. Bound by the tensor cores; a flash-style kernel with K/V
  tiles streamed through shared memory and an online f32 softmax.
- ``small_mha_attention`` (``csrc/small_mha.cu``) replaces the Pallas kernel
  ``ctrlv_tpu/ops/mha.py::small_mha_attention``: the temporal self-attention
  over F=25 frames for thousands of pixels. Bound by device memory; one warp
  per (pixel, head), scores kept in registers.

The source of each kernel says more about its design.

A wrapper takes the plain version only for a tensor on the CPU. For a CUDA
tensor it launches its kernel or raises; nothing falls back. Each launch adds
one to ``LAUNCHES[name]``, so a run can show that its main path went through
the kernels. ``plain_attention()`` makes ``models.layers.Attention`` call the
plain versions instead, for comparing the two on the card.

The gates keep the JAX package's shape conditions and drop its TPU memory
budgets.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

LAUNCHES = {"mha": 0, "small_mha": 0}
_plain = False


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def plain_attention():
    """Inside this block, the model's attention takes the plain versions."""
    global _plain
    prev, _plain = _plain, True
    try:
        yield
    finally:
        _plain = prev


def plain_selected() -> bool:
    return _plain


def mha_supported(sq: int, sk: int, hd: int, heads: int) -> bool:
    return hd % heads == 0 and hd // heads in (64, 128) and sq >= 1024 and sk >= 1024


def small_mha_supported(n: int, sq: int, sk: int, hd: int, heads: int) -> bool:
    return (
        sq == sk
        and 2 <= sq <= 64
        and hd % heads == 0
        and hd // heads in (64, 128)
        and n >= 256
    )


def attention_plain(q3, k3, v3, heads: int, scale: float):
    """Head-sliced softmax attention over (B, S, H*D): f32 logits and softmax,
    weights cast to the input dtype before the product with V. One head at a
    time, so the f32 logits of only one head are alive."""
    d = q3.shape[-1] // heads
    out = torch.empty_like(q3)
    for h in range(heads):
        sl = slice(h * d, (h + 1) * d)
        logits = torch.matmul(q3[..., sl].float(), k3[..., sl].float().transpose(-1, -2))
        w = torch.softmax(logits * scale, dim=-1).to(q3.dtype)
        out[..., sl] = torch.matmul(w, v3[..., sl])
    return out


# The plain versions of the two kernels: the same math, any shape.
mha_attention_plain = attention_plain
small_mha_attention_plain = attention_plain


def _check_cuda(name: str, q3, k3, v3, heads: int) -> int:
    """Validate the kernel's operands; returns the head dim."""
    for t in (q3, k3, v3):
        if t.device != q3.device:
            raise ValueError(f"{name}: operands on different devices")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bfloat16, got {t.dtype}")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous (B, S, H*D)")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operand not 16-byte aligned")
    hd = q3.shape[-1]
    if k3.shape != v3.shape or k3.shape[0] != q3.shape[0] or k3.shape[-1] != hd:
        raise ValueError(f"{name}: shapes {tuple(q3.shape)}, {tuple(k3.shape)}, {tuple(v3.shape)}")
    if hd % heads or hd // heads not in (64, 128):
        raise ValueError(f"{name}: head dim {hd}/{heads} is not 64 or 128")
    return hd // heads


def _launch(name: str, fn_name: str, q3, k3, v3, out, ints, scale: float) -> None:
    from ._build import load

    lib = load()
    with torch.cuda.device(q3.device):
        stream = torch.cuda.current_stream(q3.device).cuda_stream
        rc = getattr(lib, fn_name)(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(),
            *ints, ctypes.c_float(scale), stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")
    LAUNCHES[name] += 1


def mha_attention(q3, k3, v3, heads: int, scale: float):
    """softmax(q k^T * scale) v per head over (B, Sq, H*D) x (B, Sk, H*D)."""
    if q3.device.type == "cpu":
        return mha_attention_plain(q3, k3, v3, heads, scale)
    if q3.device.type != "cuda":
        raise ValueError(f"mha_attention: no kernel for device {q3.device}")
    d = _check_cuda("mha", q3, k3, v3, heads)
    b, sq, _ = q3.shape
    out = torch.empty_like(q3)
    _launch("mha", "ctrlv_mha_fwd", q3, k3, v3, out, (b, sq, k3.shape[1], heads, d), scale)
    return out


def small_mha_attention(q3, k3, v3, heads: int, scale: float):
    """Attention over (N, F, H*D) with few frames F and many rows N."""
    if q3.device.type == "cpu":
        return small_mha_attention_plain(q3, k3, v3, heads, scale)
    if q3.device.type != "cuda":
        raise ValueError(f"small_mha_attention: no kernel for device {q3.device}")
    d = _check_cuda("small_mha", q3, k3, v3, heads)
    n, f, _ = q3.shape
    if k3.shape[1] != f or not 1 <= f <= 64:
        raise ValueError(f"small_mha: needs Sq == Sk <= 64, got {f} and {k3.shape[1]}")
    out = torch.empty_like(q3)
    _launch("small_mha", "ctrlv_small_mha_fwd", q3, k3, v3, out, (n, f, heads, d), scale)
    return out
