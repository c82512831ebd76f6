"""The fused spatial ResNet block: the kernel and its plain version.

Counterpart of ``ctrlv_tpu/ops/resblock.py``. ``fused_resblock2d`` replaces
the Pallas kernel ``ctrlv_tpu/ops/resblock.py::fused_resblock2d``
(``_resblock_kernel``) with ``csrc/resblock.cu``: for one same-channel
``ResnetBlock2D``

    h = conv3x3(SiLU(GN1(x))) + (bias1 + temb)
    y = conv3x3(SiLU(GN2(h))) + bias2 + x

with both GroupNorms' f32 statistics over the whole sample (E[x^2] - E[x]^2,
clamped at 0), the affine a * x + b and the SiLU in f32 and one rounding to
the working dtype; both convolutions as nine shifted products with f32
accumulation and zeros outside the image; h rounded ONCE, after bias and
temb were added in f32, and GN2's statistics taken from the rounded h; y
rounded once, after bias and residual were added in f32. The unfused module
rounds conv1's output and then the sum with temb, so fused and unfused
differ by a bf16 ulp of h, by design. ``temb`` (N, C) is the time embedding
already SiLU'd and projected: that small Linear stays outside, as in the JAX
package.

Layout: the port's. x and y are contiguous (N, C, H, W); the weights are
``nn.Conv2d``'s (C_out, C_in, 3, 3). The JAX function takes (N, H, W, C) and
(3, 3, C_in, C_out); the tests permute.

On an H100 the kernel is bound by the tensor cores (2 * 2 * N*H*W * 9*C*C
operations against 4 * N*C*H*W + 36 * C*C bytes). A TPU program holds a whole
sample and both weight stacks in VMEM; a Hopper block cannot, so a call is
five launches counted as one: the weights re-laid to (9, C_out, C_in) (anew
on every call, so the copy is never stale when they train), GN1's sums, conv1
(which also leaves per-tile sums of the rounded h in scratch), and conv2,
which folds GN2 from those sums in a fixed order. h passes through device
memory; no float atomics, so two runs agree to the bit. The source says more.

``_plan`` is the kernel's gate, a pure function of shape and dtype: bf16, C
a multiple of 320 whose group size divides 160 (320, 640 and 1280 at 32
groups), W a multiple of 8 that divides 128; H is free, the last tile of
image rows is masked. ``resblock_supported`` adds the switch: off by
default, because on the H100 the kernel lost the A/B of the denoise step to
the two cuDNN convolutions with the norm kernel between them (PERF.md).

A CPU tensor takes the plain version. A CUDA tensor launches the kernel or
raises, also on a shape the gate refuses. The gradient recomputes through
the plain version, as the JAX package's custom VJP recomputes through its
reference; the TPU kernel has no backward kernel either.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._launch import check_operand, launch, with_recompute

_ENABLED = False

# as csrc/resblock.cu has them: output pixels and output channels of a block,
# input channels of a chunk
_TILE_PIXELS, _COUT_BLOCK, _K_CHUNK = 128, 160, 64


def set_fused_resblock(on: bool) -> None:
    """Route ``ResnetBlock2D`` to the fused kernel where the gate passes."""
    global _ENABLED
    _ENABLED = bool(on)


def _plan(n: int, c: int, h: int, w: int, groups: int, dtype):
    """(image rows of a tile, tiles of a sample, channel blocks), or None
    where the kernel does not take the shape."""
    if dtype != torch.bfloat16 or groups < 1 or c < 1 or c % groups:
        return None
    if c % _COUT_BLOCK or c % _K_CHUNK or _COUT_BLOCK % (c // groups):
        return None
    if w < 8 or w % 8 or _TILE_PIXELS % w or h < 1:
        return None
    rows = _TILE_PIXELS // w
    tiles = -(-h // rows)
    if not 0 < n <= 65535 or tiles > 65535 or n * c * h * w >= 2**31:
        return None
    return rows, tiles, c // _COUT_BLOCK


def resblock_supported(n: int, c: int, h: int, w: int, groups: int, dtype) -> bool:
    return _ENABLED and _plan(n, c, h, w, groups, dtype) is not None


def fused_resblock2d_plain(x, g1, b1, w1, wb1, temb, g2, b2, w2, wb2, groups: int = 32,
                           eps: float = 1e-5):
    """The kernel's arithmetic with the kernel's roundings, on (N, C, H, W)."""
    dtype = x.dtype
    n, c = x.shape[:2]

    def norm_silu(z, gamma, beta):
        zf = z.float()
        grouped = zf.reshape(n, groups, -1)
        mean = grouped.mean(dim=-1)
        var = (grouped.square().mean(dim=-1) - mean.square()).clamp_min(0.0)
        per_channel = lambda s: s.repeat_interleave(c // groups, dim=1)  # noqa: E731
        a = per_channel(torch.rsqrt(var + eps)) * gamma.float()
        b = beta.float() - per_channel(mean) * a
        return F.silu(zf * a[:, :, None, None] + b[:, :, None, None]).to(dtype)

    def conv(z, w):  # products of working-dtype values, accumulated in f32
        return F.conv2d(z.float(), w.float(), padding=1)

    h = conv(norm_silu(x, g1, b1), w1) + (wb1.float() + temb.float())[:, :, None, None]
    h = h.to(dtype)
    y = conv(norm_silu(h, g2, b2), w2) + wb2.float()[None, :, None, None] + x.float()
    return y.to(dtype)


def _resblock_cuda(x, g1, b1, w1, wb1, temb, g2, b2, w2, wb2, groups: int, eps: float):
    if x.dim() != 4:
        raise ValueError(f"fused_resblock2d: x must be (N, C, H, W), got {tuple(x.shape)}")
    n, c, h, w = x.shape
    check_operand("fused_resblock2d", x, torch.bfloat16)
    plan = _plan(n, c, h, w, groups, x.dtype)
    if plan is None:
        raise ValueError(
            f"fused_resblock2d: the kernel does not take (N, C, H, W) = {tuple(x.shape)} with "
            f"{groups} groups; it takes C a multiple of 320 whose group size divides "
            f"{_COUT_BLOCK} and W a multiple of 8 that divides {_TILE_PIXELS}"
        )
    for wk in (w1, w2):
        if wk.shape != (c, c, 3, 3):
            raise ValueError(
                f"fused_resblock2d: weight of shape {tuple(wk.shape)} for {c} channels")
        check_operand("fused_resblock2d", wk, torch.bfloat16, x.device)
    vectors = [g1, b1, wb1, g2, b2, wb2]
    if any(v.shape != (c,) for v in vectors) or temb.shape != (n, c):
        raise ValueError(
            f"fused_resblock2d: per-channel operands {[tuple(v.shape) for v in vectors]} and "
            f"temb {tuple(temb.shape)} for x {tuple(x.shape)}"
        )
    # the kernel reads the six vectors as all bf16 or all f32, temb as either
    if not all(v.dtype == torch.bfloat16 for v in vectors):
        vectors = [v.float() for v in vectors]
    vectors = [v.contiguous() for v in vectors]
    if temb.dtype != torch.bfloat16:
        temb = temb.float()
    temb = temb.contiguous()
    for v in (*vectors, temb):
        check_operand("fused_resblock2d", v, v.dtype, x.device)
    g1, b1, wb1, g2, b2, wb2 = vectors
    _, tiles, _ = plan
    y, hidden = torch.empty_like(x), torch.empty_like(x)
    w_relaid = torch.empty((2, 9, c, c), dtype=torch.bfloat16, device=x.device)
    stats1 = torch.empty((n, groups, 2), dtype=torch.float32, device=x.device)
    stats2 = torch.empty((n, tiles, groups, 2), dtype=torch.float32, device=x.device)
    launch(
        "resblock", "ctrlv_resblock_fwd", x.device,
        x.data_ptr(), g1.data_ptr(), b1.data_ptr(), w1.data_ptr(), wb1.data_ptr(),
        temb.data_ptr(), g2.data_ptr(), b2.data_ptr(), w2.data_ptr(), wb2.data_ptr(),
        y.data_ptr(), hidden.data_ptr(), w_relaid.data_ptr(), stats1.data_ptr(),
        stats2.data_ptr(), n, c, h, w, groups, int(g1.dtype == torch.bfloat16),
        int(temb.dtype == torch.bfloat16), ctypes.c_float(eps),
    )
    return y


def fused_resblock2d(x, g1, b1, w1, wb1, temb, g2, b2, w2, wb2, groups: int = 32,
                     eps: float = 1e-5):
    """y = conv2(SiLU(GN2(conv1(SiLU(GN1(x))) + wb1 + temb))) + wb2 + x over
    (N, C, H, W); w1, w2 (C, C, 3, 3); temb (N, C), SiLU'd and projected."""
    if x.device.type == "cpu":
        return fused_resblock2d_plain(x, g1, b1, w1, wb1, temb, g2, b2, w2, wb2, groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_resblock2d: no kernel for device {x.device}")
    return with_recompute(
        lambda *t: _resblock_cuda(*t, groups, eps),
        lambda *t: fused_resblock2d_plain(*t, groups, eps),
        x, g1, b1, w1, wb1, temb, g2, b2, w2, wb2,
    )
