"""LayerNorm over the last axis: the plain version and the one-pass kernel.

Counterpart of ``ctrlv_tpu/ops/layer_norm.py``. ``layer_norm`` replaces the
Pallas kernel ``ctrlv_tpu/ops/layer_norm.py::layer_norm`` (``_ln_kernel``)
with ``csrc/layer_norm.cu``: rows are independent, one warp holds a row in
registers, computes the f32 mean and E[x^2] - mean^2 (clamped at 0), applies
``rsqrt(var + eps)`` and the affine in f32 and rounds once to the output
dtype. The row count need not divide anything.

A CPU tensor takes the plain version. A CUDA tensor whose shape and dtype
pass ``layer_norm_supported`` launches the kernel or raises, while the
switch is on; other CUDA tensors (f32 activations, a width that is not a
multiple of 8 or is above 2048) take the plain version by the gate.
"""

from __future__ import annotations

import ctypes

import torch

from ._launch import check_operand, launch

_MAX_WIDTH = 2048  # 8 vectors of 8 bf16 per lane

# On by default: on the H100 the kernel made the full-width denoise step
# faster than the plain version (PERF.md, step A/B).
_FUSED_LN = True


def set_fused_layer_norm(on: bool) -> None:
    global _FUSED_LN
    _FUSED_LN = bool(on)


def layer_norm_supported(shape, dtype, param_dtype) -> bool:
    """Gate of the kernel, a pure function of shape and dtype."""
    if len(shape) < 1:
        return False
    c = shape[-1]
    rows = 1
    for d in shape[:-1]:
        rows *= d
    return (
        dtype == torch.bfloat16
        and param_dtype in (torch.bfloat16, torch.float32)
        and c % 8 == 0
        and 8 <= c <= _MAX_WIDTH
        and 0 < rows < 2**31
    )


def layer_norm_plain(x, weight, bias, eps: float = 1e-5):
    """LayerNorm over the last axis with f32 fast-variance statistics
    (E[x^2] - E[x]^2, clamped at 0) and an f32 affine; returns x's dtype,
    rounded once."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf.square().mean(dim=-1, keepdim=True) - mean.square()).clamp_min(0.0)
    y = (xf - mean) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return y.to(x.dtype)


def _layer_norm_cuda(x, weight, bias, eps: float):
    check_operand("layer_norm", x, torch.bfloat16)
    c = x.shape[-1]
    for p in (weight, bias):
        check_operand("layer_norm", p, weight.dtype, x.device)
        if p.shape != (c,):
            raise ValueError(f"layer_norm: parameter of shape {tuple(p.shape)} for width {c}")
    if weight.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"layer_norm: parameters must be bfloat16 or float32, got {weight.dtype}")
    if c % 8 or not 8 <= c <= _MAX_WIDTH:
        raise ValueError(f"layer_norm: width {c} is not a multiple of 8 in [8, {_MAX_WIDTH}]")
    out = torch.empty_like(x)
    launch(
        "layer_norm", "ctrlv_layer_norm_fwd", x.device,
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
        x.numel() // c, c, int(weight.dtype == torch.bfloat16), ctypes.c_float(eps),
    )
    return out


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm over the last axis of (..., C), f32 statistics."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: no kernel for device {x.device}")
    if _FUSED_LN and layer_norm_supported(x.shape, x.dtype, weight.dtype):
        return _layer_norm_cuda(x, weight, bias, eps)
    return layer_norm_plain(x, weight, bias, eps)
