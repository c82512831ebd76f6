"""GroupNorm with an optional SiLU over channels-first (B, C, *spatial)
tensors: the plain version and the one-pass kernel.

Counterpart of ``ctrlv_tpu/ops/group_norm.py``. ``group_norm`` replaces the
Pallas kernel ``ctrlv_tpu/ops/group_norm.py::group_norm`` (``_gn_kernel``)
with ``csrc/group_norm.cu``: f32 sum and sum of squares per (sample, group),
variance E[x^2] - E[x]^2 clamped at 0, ``rsqrt(var + eps)``, the affine and
the optional SiLU in f32, one rounding to the output dtype. The JAX package
is channels-last and needs a one-hot group map; here one (sample, group) is
one contiguous run of (C/G) * prod(spatial) elements, which the kernel reads
once (short runs, held in shared memory) or twice (long runs, split over
several blocks).

A CPU tensor takes the plain version. A CUDA tensor whose shape and dtype
pass ``group_norm_supported`` launches the kernel or raises, while the
switch is on; other CUDA tensors (f32 activations, C not a multiple of the
group count) take the plain version by the gate.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ._launch import check_operand, launch

# Runs of at most this many elements are normalised from shared memory in one
# read; longer ones are read twice, split into slices of this many elements
# over at most this many blocks: every block adds all of its run's partial
# sums, so more slices than that cost more than they spread.
_SMEM_RUN_ELEMS = 80 * 1024
_SPLIT_ELEMS = 16 * 1024
_MAX_SPLITS = 64

# On by default: on the H100 the kernel made the full-width denoise step
# faster than the plain version (PERF.md, step A/B).
_FUSED_GN = True


def set_fused_group_norm(on: bool) -> None:
    global _FUSED_GN
    _FUSED_GN = bool(on)


def group_norm_supported(shape, num_groups: int, dtype, param_dtype) -> bool:
    """Gate of the kernel, a pure function of shape and dtype."""
    if len(shape) < 2 or shape[1] % num_groups:
        return False
    run = shape[1] // num_groups
    for d in shape[2:]:
        run *= d
    return (
        dtype == torch.bfloat16
        and param_dtype in (torch.bfloat16, torch.float32)
        and 0 < run < 2**30
        and 0 < shape[0] * num_groups < 2**31
    )


def group_norm_plain(x, weight, bias, num_groups: int = 32, eps: float = 1e-6,
                     act: Optional[str] = None):
    """GroupNorm over (B, C, *spatial) with f32 fast-variance statistics
    (E[x^2] - E[x]^2, clamped at 0), consecutive channel groups, the affine
    and the optional SiLU in f32; returns x's dtype, rounded once."""
    b, c = x.shape[:2]
    xf = x.float().reshape(b, num_groups, -1)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf.square().mean(dim=-1, keepdim=True) - mean.square()).clamp_min(0.0)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    y = y * weight.float().reshape(shape) + bias.float().reshape(shape)
    if act == "silu":
        y = F.silu(y)
    return y.to(x.dtype)


def _group_norm_cuda(x, weight, bias, num_groups: int, eps: float, act: Optional[str]):
    check_operand("group_norm", x, torch.bfloat16)
    c = x.shape[1]
    for p in (weight, bias):
        check_operand("group_norm", p, weight.dtype, x.device)
        if p.shape != (c,):
            raise ValueError(f"group_norm: parameter of shape {tuple(p.shape)} for {c} channels")
    if weight.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"group_norm: parameters must be bfloat16 or float32, got {weight.dtype}")
    if c % num_groups:
        raise ValueError(f"group_norm: {c} channels do not split into {num_groups} groups")
    runs = x.shape[0] * num_groups
    spatial = x[0, 0].numel()
    run = (c // num_groups) * spatial
    out = torch.empty_like(x)
    if run <= _SMEM_RUN_ELEMS:
        splits, scratch_ptr = 1, 0
    else:
        splits = min(_MAX_SPLITS, max(2, -(-run // _SPLIT_ELEMS)))
        scratch = torch.empty((runs, splits, 2), dtype=torch.float32, device=x.device)
        scratch_ptr = scratch.data_ptr()
    launch(
        "group_norm", "ctrlv_group_norm_fwd", x.device,
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(), scratch_ptr,
        ctypes.c_longlong(runs), ctypes.c_longlong(run), ctypes.c_longlong(spatial),
        c // num_groups, num_groups, splits, int(weight.dtype == torch.bfloat16),
        int(act == "silu"), ctypes.c_float(eps),
    )
    return out


def group_norm(x, weight, bias, num_groups: int = 32, eps: float = 1e-6,
               act: Optional[str] = None):
    """GroupNorm(+activation) over (B, C, *spatial); ``act`` in {None, "silu"}."""
    if act not in (None, "silu"):
        raise ValueError(f"group_norm: act {act!r} is not None or 'silu'")
    if x.device.type == "cpu":
        return group_norm_plain(x, weight, bias, num_groups, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm: no kernel for device {x.device}")
    if _FUSED_GN and group_norm_supported(x.shape, num_groups, x.dtype, weight.dtype):
        return _group_norm_cuda(x, weight, bias, num_groups, eps, act)
    return group_norm_plain(x, weight, bias, num_groups, eps, act)
