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
operations against 4 * N*C*H*W + 36 * C*C bytes). A TPU program holds a
whole sample and both weight stacks in VMEM; a Hopper block cannot, so a call
is four launches counted as one: GN1's sums, conv1 (which also leaves
per-(tile, sample) sums of the rounded h in scratch), GN2's sums folded from
those in a fixed order, and conv2. Each convolution is an implicit GEMM on
``wgmma`` (register A from the normalised input, staged with a zero halo;
weight tiles by TMA), over M tiles of 128 pixels that are whole image rows of
one or several samples, and 160 or 320 output channels a block (``_plan``).
h passes through device memory; no float atomics, so two runs agree to the
bit. The source says more.

The kernel reads each conv weight re-laid to (9, C_out, C_in). The copy is
made once and reused while the weight is unchanged (``RelaidWeights``): the
cache knows a weight by the tensor object and checks its ``data_ptr()``,
``_version``, shape, dtype and device on every call. Writes in place
(``copy_``, ``add_``, the port's optimizers, ``load_state_dict``) bump
``_version`` and so cause a fresh re-layout; a write through ``.data`` does
not bump it, and the kernel would go on reading the old copy. The cache holds
one copy per weight (9 * C * C bf16: 29.5 MB at C = 1280) while the weight lives.

``_plan`` is the kernel's gate and tiling, a pure function of shape and
dtype, mirrored by ``make_plan`` in the source: bf16, C a multiple of 320
whose group size divides 160 (320, 640 and 1280 at 32 groups), W a multiple
of 8 that divides 128; H is free. The kernel is no slower than the library
chain at any shape of the paths (PERF.md), so the model routes every shape
the gate admits. ``resblock_supported`` adds the switch, off by default: the
kernel wins the denoise step's A/B, but the stage-1 training micro-step is
slower with it on, because its gradient recomputes through the f32 plain
version (PERF.md).

A CPU tensor takes the plain version. A CUDA tensor launches the kernel or
raises, also on a shape the gate refuses. The gradient recomputes through
the plain version, as the JAX package's custom VJP recomputes through its
reference; the TPU kernel has no backward kernel either.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from ._launch import check_operand, launch, with_recompute

_ENABLED = False

# as csrc/resblock.cu has them: output pixels of a block and output channels
# of one of its products, input channels of a stage, the bf16 row stride of an
# A buffer, the bytes of a 160 x 64 weight tile, the epilogue's f32 tile and
# the barriers, the shared memory a block may take, and an H100's SMs
_TILE_PIXELS, _COUT_BLOCK, _K_CHUNK, _A_ROW = 128, 160, 64, 72
_B_TILE, _OUT_BYTES, _BAR_BYTES = 160 * 64 * 2, 160 * (128 + 4) * 4, 8 * 12
_MAX_STAGES, _SMEM_MAX, _SMS = 4, 232448 - 1024, 132


class Plan(NamedTuple):
    """The kernel's tiling of one call (``make_plan`` in csrc/resblock.cu)."""

    rows: int      # image rows of a 128-pixel M tile (128 / W)
    tiles: int     # M tiles over the N * H image rows; only the last is ragged
    max_seg: int   # samples one tile touches, at most
    slots: int     # pixel slots of an A buffer: (rows + 2 * max_seg) * (W + 2)
    halves: int    # output channels of a block: 160 * halves
    stages: int    # weight stages in flight
    smem: int      # dynamic shared memory of a block, bytes
    cblocks: int   # blocks along the output channels
    padding: float  # share of the M tiles' pixels past the last image row

    @property
    def blocks(self) -> int:
        return self.tiles * self.cblocks


def set_fused_resblock(on: bool) -> None:
    """Route ``ResnetBlock2D`` to the fused kernel where the gate passes."""
    global _ENABLED
    _ENABLED = bool(on)


def _samples_touched(g0: int, rows: int, total_rows: int, h: int) -> int:
    return (min(g0 + rows, total_rows) - 1) // h - g0 // h + 1


def _plan(n: int, c: int, h: int, w: int, groups: int, dtype):
    """The ``Plan`` of a call, or None where the kernel does not take the shape."""
    if dtype != torch.bfloat16 or groups < 1 or c < 1 or c % groups:
        return None
    if c % _COUT_BLOCK or c % _K_CHUNK or _COUT_BLOCK % (c // groups):
        return None
    if w < 8 or w % 8 or _TILE_PIXELS % w or h < 1 or n < 1:
        return None
    if n * c * h * w >= 2**31:
        return None
    rows = _TILE_PIXELS // w
    tiles = -(-n * h // rows)
    # tile t starts at image row t * rows: the pattern of samples repeats within h tiles
    max_seg = max(_samples_touched(t * rows, rows, n * h, h) for t in range(min(tiles, h)))
    slots = (rows + 2 * max_seg) * (w + 2)
    a_bytes = 2 * slots * _A_ROW * 2
    fixed = 1024 + a_bytes + _BAR_BYTES + 4 * (2 * c + 2 * max_seg * groups)
    # 320 output channels a block where that still leaves a block for every SM
    for halves in (2, 1):
        if c % (_COUT_BLOCK * halves) or (halves == 2 and tiles * (c // 320) < _SMS):
            continue
        for stages in range(_MAX_STAGES, 1, -1):
            ring = stages * halves * _B_TILE
            if fixed + ring <= _SMEM_MAX and ring + a_bytes >= _OUT_BYTES:
                return Plan(rows, tiles, max_seg, slots, halves, stages, fixed + ring,
                            c // (_COUT_BLOCK * halves), 1.0 - n * h / (tiles * rows))
    return None


def resblock_supported(n: int, c: int, h: int, w: int, groups: int, dtype) -> bool:
    return _ENABLED and _plan(n, c, h, w, groups, dtype) is not None


class RelaidWeights:
    """``relayout(w)`` once per weight and per state of it: the copy is
    served again while ``w`` is the same tensor object with the same
    ``data_ptr()``, ``_version``, shape, dtype and device. An entry goes when
    its tensor does; ``relayouts`` counts the copies made."""

    def __init__(self, relayout: Callable[[torch.Tensor], torch.Tensor]):
        self._relayout = relayout
        self._cache: dict = {}  # id(w) -> (weak reference to w, its state, the copy)
        self.relayouts = 0

    def __call__(self, w: torch.Tensor) -> torch.Tensor:
        state = (w.data_ptr(), w._version, tuple(w.shape), w.dtype, w.device)
        hit = self._cache.get(id(w))
        if hit is not None and hit[0]() is w and hit[1] == state:
            return hit[2]
        if hit is None or hit[0]() is not w:
            weakref.finalize(w, self._cache.pop, id(w), None)
        out = self._relayout(w)
        self.relayouts += 1
        self._cache[id(w)] = (weakref.ref(w), state, out)
        return out


def _relayout_cuda(w: torch.Tensor) -> torch.Tensor:
    """(C_out, C_in, 3, 3) -> (9, C_out, C_in) on the card, by the kernel's helper."""
    c = w.shape[0]
    out = torch.empty((9, c, c), dtype=torch.bfloat16, device=w.device)
    launch("resblock", "ctrlv_resblock_relayout", w.device, w.data_ptr(), out.data_ptr(), c,
           count=False)
    return out


relaid_weights = RelaidWeights(_relayout_cuda)


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
    wr1, wr2 = relaid_weights(w1), relaid_weights(w2)
    y, hidden = torch.empty_like(x), torch.empty_like(x)
    stats1 = torch.empty((n, groups, 2), dtype=torch.float32, device=x.device)
    stats2 = torch.empty((plan.tiles, plan.max_seg, groups, 2), dtype=torch.float32,
                         device=x.device)
    launch(
        "resblock", "ctrlv_resblock_fwd", x.device,
        x.data_ptr(), g1.data_ptr(), b1.data_ptr(), wr1.data_ptr(), wb1.data_ptr(),
        temb.data_ptr(), g2.data_ptr(), b2.data_ptr(), wr2.data_ptr(), wb2.data_ptr(),
        y.data_ptr(), hidden.data_ptr(), stats1.data_ptr(), stats2.data_ptr(),
        n, c, h, w, groups, int(g1.dtype == torch.bfloat16),
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
