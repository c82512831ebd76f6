"""LayerNorm over the last axis: the plain version and the one-pass kernel.

Counterpart of ``ctrlv_tpu/ops/layer_norm.py``. ``layer_norm`` replaces the
Pallas kernel ``ctrlv_tpu/ops/layer_norm.py::layer_norm`` (``_ln_kernel``)
with ``csrc/layer_norm.cu``: rows are independent; a persistent grid of
warps walks them, each row held in registers by the lanes ``_plan`` gives it,
and computes the f32 mean and E[x^2] - mean^2 (clamped at 0), applies
``rsqrt(var + eps)`` and the affine in f32 and rounds once to the output
dtype. The row count need not divide anything.

A CPU tensor takes the plain version. A CUDA tensor whose shape and dtype
pass ``layer_norm_supported`` launches the kernel or raises, while the
switch is on; other CUDA tensors (f32 activations, a width that is not a
multiple of 8 or is above 2048) take the plain version by the gate.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from ._launch import check_operand, launch, with_recompute

_MAX_WIDTH = 2048  # 32 lanes x 8 vectors of 8 bf16
SMS, WARPS = 132, 8  # the H100's SMs; warps a block (csrc/layer_norm.cu, kWarps)
CTAS_PER_SM = 2  # blocks an SM the persistent grid is sized for (the A/B, PERF.md)

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


@dataclass(frozen=True)
class Plan:
    """A launch of the kernel: a row of ``vecs`` * ``lanes`` 16-byte vectors
    (the last ones partly past the row's end) is held by ``lanes`` lanes,
    ``rows_per_warp`` = 32 / lanes rows a warp at once; a grid of ``blocks``
    blocks of 8 warps."""

    lanes: int
    vecs: int
    rows_per_warp: int
    blocks: int


@functools.lru_cache(maxsize=256)
def _plan(rows: int, c: int, ctas: int = CTAS_PER_SM) -> Plan:
    """The lanes a row (the power of two at or above C / 40, at most 32: the
    model's 320, 640 and 1280 are 8, 16 and 32 lanes x 5 vectors, a warp's
    lanes all loaded), as the C entry chooses them, and the persistent grid."""
    nvec = c // 8
    lanes = 1
    while lanes < 32 and lanes * 5 < nvec:
        lanes *= 2
    rpw = 32 // lanes
    groups = -(-rows // rpw)  # of rpw rows, one a warp at a time
    blocks = min(-(-groups // WARPS), SMS * ctas)
    return Plan(lanes, -(-nvec // lanes), rpw, blocks)


def layer_norm_plain(x, weight, bias, eps: float = 1e-5):
    """LayerNorm over the last axis with f32 fast-variance statistics
    (E[x^2] - E[x]^2, clamped at 0) and an f32 affine; returns x's dtype,
    rounded once."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf.square().mean(dim=-1, keepdim=True) - mean.square()).clamp_min(0.0)
    y = (xf - mean) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return y.to(x.dtype)


def _layer_norm_cuda(x, weight, bias, eps: float, plan: Plan | None = None):
    """The kernel on ``plan``, by default ``_plan``'s for x's shape."""
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
    rows = x.numel() // c
    plan = plan or _plan(rows, c)
    out = torch.empty_like(x)
    launch(
        "layer_norm", "ctrlv_layer_norm_fwd", x.device,
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
        rows, c, int(weight.dtype == torch.bfloat16), eps, plan.blocks,
    )
    return out


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm over the last axis of (..., C), f32 statistics."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: no kernel for device {x.device}")
    if _FUSED_LN and layer_norm_supported(x.shape, x.dtype, weight.dtype):
        # a gradient recomputes through the plain version (fast variance)
        return with_recompute(
            lambda *t: _layer_norm_cuda(*t, eps),
            lambda *t: layer_norm_plain(*t, eps),
            x, weight, bias,
        )
    return layer_norm_plain(x, weight, bias, eps)
