"""Multi-head attention over (B, S, H*D) tensors, heads packed in the last axis.

The operands are exactly what the Q/K/V linear layers emit; no head-major
copy is made. Three kernels, each a CUDA C++ kernel for Hopper (sm_90a) with
its plain PyTorch version beside it:

- ``mha_attention`` (``csrc/mha.cu``) replaces the Pallas kernel
  ``ctrlv_tpu/ops/mha.py::mha_attention``: the spatial self-attention at the
  2560-token level. Bound by the tensor cores; a persistent, warp-specialised
  flash-attention forward (TMA copies, ``wgmma`` products, an online f32
  softmax), whose instantiation ``tile_plan`` mirrors.
- ``small_mha_attention`` (``csrc/small_mha.cu``) replaces the Pallas kernel
  ``ctrlv_tpu/ops/mha.py::small_mha_attention``: the temporal self-attention
  over F=25 frames for thousands of pixels. Bound by device memory; one warp
  per (pixel, head), scores kept in registers.
- ``small_mha_attention_fm`` (the same source, other strides) replaces
  ``ctrlv_tpu/ops/mha.py::small_mha_attention_fm``: the same attention over
  frames, read from the UNet's own (B*F, S, H*D) layout, so that the
  transpose pair around the temporal block never reaches device memory.

The source of each kernel says more about its design.

A wrapper takes the plain version only for a tensor on the CPU. For a CUDA
tensor it launches its kernel or raises; nothing falls back. Each launch adds
one to ``LAUNCHES[name]``, so a run can show that its main path went through
the kernels. ``plain_kernels()`` makes the model modules call the plain
versions instead, for comparing the two on the card.

An operand that requires a gradient gets one: the backward pass recomputes
through the plain version (``_launch.with_recompute``), the spatial kernel
one head at a time, as the JAX package's custom VJPs do.

The gates keep the JAX package's shape conditions and drop its TPU memory
budgets.
"""

from __future__ import annotations

import ctypes

import torch

from ._launch import (  # noqa: F401  (re-exported: callers read them here)
    LAUNCHES,
    check_operand,
    check_tma_operands,
    launch,
    plain_kernels,
    plain_selected,
    recompute_backward,
    reset_launch_counts,
    with_recompute,
)

def mha_supported(sq: int, sk: int, hd: int, heads: int) -> bool:
    return hd % heads == 0 and hd // heads in (64, 128) and sq >= 1024 and sk >= 1024


def tile_plan(sq: int, sk: int, head_dim: int, flash: bool) -> tuple[int, int, int]:
    """(query rows a block, keys a tile, K/V stages) that ``csrc/mha.cu``
    takes for a call: a mirror of its C ``tile_plan``, for the tests and the
    smoke run. K1's entry at head dim 64: 192 query rows (three consumer
    warpgroups); otherwise 128 (two). Keys come in tiles of 128. K8's entry
    (``flash``) takes 64 query rows and 64-key tiles where the last 128-row
    query tile would be at most half full. Four stages at head dim 64, two
    at 128."""
    del sk  # every plan streams any number of keys
    stages = 4 if head_dim == 64 else 2
    if not flash and head_dim == 64:
        return 192, 128, stages
    block = 64 if flash and 1 <= sq % 128 <= 64 else 128
    return block, block, stages


def small_mha_supported(n: int, sq: int, sk: int, hd: int, heads: int) -> bool:
    return (
        sq == sk
        and 2 <= sq <= 64
        and hd % heads == 0
        and hd // heads in (64, 128)
        and n >= 256
    )


def small_mha_fm_supported(bf: int, s: int, hd: int, heads: int, f: int) -> bool:
    """Gate of the frames-major kernel on (B*F, S, H*D) with F frames."""
    return (
        2 <= f <= 64
        and bf % f == 0
        and hd % heads == 0
        and hd // heads in (64, 128)
        and (bf // f) * s >= 256
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


# The plain versions of the two seq-layout kernels: the same math, any shape.
mha_attention_plain = attention_plain
small_mha_attention_plain = attention_plain


def small_mha_attention_fm_plain(q3, k3, v3, heads: int, scale: float, num_frames: int):
    """The frames-major attention with its transposes written out: to
    (B*S, F, H*D), ``attention_plain``, and back to (B*F, S, H*D)."""
    bf, s, hd = q3.shape
    b = bf // num_frames

    def to_seq(x):
        return x.reshape(b, num_frames, s, hd).transpose(1, 2).reshape(b * s, num_frames, hd)

    out = attention_plain(to_seq(q3), to_seq(k3), to_seq(v3), heads, scale)
    return out.reshape(b, s, num_frames, hd).transpose(1, 2).reshape(bf, s, hd)


def _check_cuda(name: str, q3, k3, v3, heads: int, tma: bool = False) -> int:
    """Validate the kernel's operands; returns the head dim. ``tma``: the
    kernel copies them by TMA (``csrc/mha.cu``)."""
    for t in (q3, k3, v3):
        check_operand(name, t, torch.bfloat16, q3.device)
        if t.dim() != 3:
            raise ValueError(f"{name}: operands must be (B, S, H*D), got {tuple(t.shape)}")
    hd = q3.shape[-1]
    if k3.shape != v3.shape or k3.shape[0] != q3.shape[0] or k3.shape[-1] != hd:
        raise ValueError(f"{name}: shapes {tuple(q3.shape)}, {tuple(k3.shape)}, {tuple(v3.shape)}")
    if hd % heads or hd // heads not in (64, 128):
        raise ValueError(f"{name}: head dim {hd}/{heads} is not 64 or 128")
    if tma:
        check_tma_operands(name, hd, q3, k3, v3)
    return hd // heads


def _launch(name: str, fn_name: str, q3, k3, v3, ints, scale: float):
    out = torch.empty_like(q3)
    launch(
        name, fn_name, q3.device,
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(), *ints, ctypes.c_float(scale),
    )
    return out


def attention_backward_sliced(heads: int, scale: float):
    """The gradient of ``attention_plain``, recomputed and differentiated one
    head at a time, so that the f32 logits of one head only are alive (all
    heads of the spatial attention at once are gigabytes)."""
    one_head = recompute_backward(lambda q, k, v: attention_plain(q, k, v, 1, scale))

    def backward(grad_out, needs, q3, k3, v3):
        d = q3.shape[-1] // heads
        grads = [torch.empty_like(t) if n else None for t, n in zip((q3, k3, v3), needs)]
        for h in range(heads):
            sl = slice(h * d, (h + 1) * d)
            part = one_head(grad_out[..., sl], needs, q3[..., sl], k3[..., sl], v3[..., sl])
            for dst, g in zip(grads, part):
                if dst is not None:
                    dst[..., sl] = g
        return tuple(grads)

    return backward


def mha_attention(q3, k3, v3, heads: int, scale: float):
    """softmax(q k^T * scale) v per head over (B, Sq, H*D) x (B, Sk, H*D)."""
    if q3.device.type == "cpu":
        return mha_attention_plain(q3, k3, v3, heads, scale)
    if q3.device.type != "cuda":
        raise ValueError(f"mha_attention: no kernel for device {q3.device}")
    d = _check_cuda("mha", q3, k3, v3, heads, tma=True)
    b, sq, _ = q3.shape
    ints = (b, sq, k3.shape[1], heads, d)
    return with_recompute(
        lambda q, k, v: _launch("mha", "ctrlv_mha_fwd", q, k, v, ints, scale),
        None, q3, k3, v3, backward=attention_backward_sliced(heads, scale),
    )


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
    return with_recompute(
        lambda q, k, v: _launch("small_mha", "ctrlv_small_mha_fwd", q, k, v, (n, f, heads, d),
                                scale),
        lambda q, k, v: small_mha_attention_plain(q, k, v, heads, scale),
        q3, k3, v3,
    )


def small_mha_attention_fm(q3, k3, v3, heads: int, scale: float, num_frames: int):
    """Attention over the F frames of each pixel of (B*F, S, H*D) operands,
    read and written in that layout."""
    if q3.device.type == "cpu":
        return small_mha_attention_fm_plain(q3, k3, v3, heads, scale, num_frames)
    if q3.device.type != "cuda":
        raise ValueError(f"small_mha_attention_fm: no kernel for device {q3.device}")
    d = _check_cuda("small_mha_fm", q3, k3, v3, heads)
    bf, s, _ = q3.shape
    if k3.shape != q3.shape or not 1 <= num_frames <= 64 or bf % num_frames:
        raise ValueError(
            f"small_mha_fm: needs Sq == Sk and B*F a multiple of F <= 64, got "
            f"{tuple(q3.shape)}, {tuple(k3.shape)}, F={num_frames}"
        )
    ints = (bf // num_frames, num_frames, s, heads, d)
    return with_recompute(
        lambda q, k, v: _launch("small_mha_fm", "ctrlv_small_mha_fm_fwd", q, k, v, ints, scale),
        lambda q, k, v: small_mha_attention_fm_plain(q, k, v, heads, scale, num_frames),
        q3, k3, v3,
    )
