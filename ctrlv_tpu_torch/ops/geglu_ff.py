"""The GEGLU feed-forward: its gelu, its unfused arithmetic, and the fused
kernel with its plain version.

Counterpart of ``ctrlv_tpu/ops/geglu_ff.py``.

``gelu_erf`` routes by dtype as the JAX package does: bf16 takes the tanh
form, which the JAX package uses there because it is the erf form at bf16
precision (at most one bf16 ulp apart); every other dtype takes the erf
form, computed in f32. A plain ``F.gelu`` on bf16 would be the erf form and
drift from the reference.

``geglu_ff`` and ``geglu_ff_ln`` replace the Pallas kernels
``ctrlv_tpu/ops/geglu_ff.py::geglu_ff`` and ``::geglu_ff_ln`` with
``csrc/geglu_ff.cu``: y = (a * gelu_erf(g)) W2^T + b2 with [a|g] = x W1^T + b1,
both products on the tensor cores with f32 accumulation, a, g and their
product rounded to bf16 as the TPU kernel rounds them, and the (M, 2*inner)
intermediate never in device memory; ``_ln`` normalises each row first (f32
fast variance, f32 gamma and beta). The weights are ``nn.Linear``'s, read
where they lie: W1 is (2*inner, C_in) with a's rows first, W2 is
(C_out, inner). On an H100 the kernel is bound by the tensor cores
(6*M*C*inner operations against 4*M*C + 6*C*inner bytes); inside the card
the erf gelu between the products and the weight bytes every block takes
from L2 weigh too. It is a warp-specialised back-to-back GEMM: a producer
warp copies x's tile once and the weights through rings of stages by TMA
(the weights kept in L2 by a cache hint), and two consumer warpgroups run
both products as ``wgmma`` with the gelu between them in registers.
``_plan`` gives its tiling (``Plan``, mirrored from the source): 128 rows a
block at C = 320, 64 at C = 640, where the register file holds no more of
y's f32 accumulator. The source says more.

At C = 1280 the back-to-back GEMM does not carry (y's f32 accumulator for 64
rows is 320 KB), so ``csrc/geglu_ff_wide.cu`` takes those calls as two
hand-written ``wgmma`` + TMA GEMMs with act through device memory: a gate
kernel (a and g of 128 rows x 128 inner columns from one x tile, the gelu in
its epilogue, act stored in bf16) and an out kernel (act W2^T + b2, tiles of
128 x 160). Same function and roundings; ``_ln`` runs K5's kernel
(``csrc/layer_norm.cu``) into a scratch tensor first. ``WidePlan`` mirrors
their tiles. One call counts one launch of ``geglu_ff``, however many
kernels it runs.

``_plan`` is also the kernel's gate, a pure function of shape and dtype. It
admits what a kernel takes: bf16, C_in = C_out in {320, 640, 1280}, inner a
multiple of 64, any M >= 1 (ragged tiles are masked) while M * C fits an
int32. ``geglu_ff_supported`` adds the switch and ``max_cin``, the JAX
package's "route only FF sites with c_in <= max_cin". The switch is on by
default, because on the H100 the kernel won the A/B of the denoise step's
device time and of the overall request (PERF.md); ``max_cin``'s default,
``DEFAULT_MAX_CIN``, is what the card's A/B of the C = 1280 route chose
(PERF.md). ``FeedForward`` takes the kernel only where autograd
wants no gradient of the call: the gradient recomputes through the unfused
chain, so in training the kernel only added its own time.

A CPU tensor takes the plain version. A CUDA tensor launches the kernel or
raises, also on a shape the gate refuses. The gradient recomputes through
``geglu_ff_unfused``, as the JAX package's custom VJP recomputes through its
unfused path.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ._launch import check_operand, launch, with_recompute
from .layer_norm import SMS, layer_norm_plain
from .layer_norm import _plan as _ln_plan

_ENABLED = True
# Route only the feed-forwards with C_in <= max_cin to the kernel (None: all
# that the gate admits). The default is the card's A/B of the C = 1280 route.
DEFAULT_MAX_CIN: int | None = None
_MAX_CIN = DEFAULT_MAX_CIN

# C -> (W1 stages, W2 stages, ping-pong), as csrc/geglu_ff.cu's Plan320 and
# Plan640 have them
_PLANS = {320: (8, 2, True), 640: (3, 1, False)}
_SUB = 32  # inner columns of a consumer's first product (a and g: 2 * _SUB)
# registers a thread of the producer and of a consumer warpgroup after setmaxnreg
_PRODUCER_REGS, _CONSUMER_REGS = 24, 240
_SMEM_MAX = 232448  # the shared memory a block may take on an H100
# csrc/geglu_ff_wide.cu at C = 1280: rows of a tile, and for the gate and the
# out kernel (Wide<gate, tile columns, stages>) their tile's columns and stages
_WIDE_C, _WIDE_ROWS = 1280, 128
_WIDE = {"gate": (128, 4), "out": (160, 6)}


class Plan(NamedTuple):
    """The kernel's tiling of one call (``Cfg`` and ``launch`` in csrc/geglu_ff.cu)."""

    rows: int        # rows of x a block: 128 at C = 320 (64 a consumer warpgroup), 64 at 640
    sub: int         # inner columns of a consumer's first product (a and g: 2 * sub)
    step: int        # inner columns of a step: sub, or 2 * sub where the consumers split y
    w1_stages: int   # ring of 64-column K slabs of the step's W1 rows
    w2_stages: int   # ring of (C, 64) slices of W2
    ping_pong: bool  # the consumers take turns to issue their products
    smem: int        # dynamic shared memory of a block, bytes
    blocks: int      # tiles of rows
    kernel: str = "back_to_back"  # csrc/geglu_ff.cu


class WidePlan(NamedTuple):
    """The two kernels of csrc/geglu_ff_wide.cu at C = 1280 (``Wide`` and
    ``launch`` there): persistent grids over tiles of ``rows`` rows."""

    rows: int         # rows of a tile: 64 a consumer warpgroup
    gate_cols: int    # inner columns of act a gate tile (from a and g alike)
    out_cols: int     # columns of y an out tile
    gate_stages: int  # ring of 64-column K slabs of x and of the tile's W1 rows
    out_stages: int   # ring of 64-column K slabs of act and of the tile's W2 rows
    gate_smem: int    # dynamic shared memory of a block, bytes
    out_smem: int
    gate_tiles: int
    out_tiles: int
    gate_blocks: int  # blocks of the persistent grid: min(tiles, SMs)
    out_blocks: int
    kernel: str = "wide"


def set_fused_geglu_ff(on: bool, max_cin: int | None = DEFAULT_MAX_CIN) -> None:
    """Route ``FeedForward`` to the fused kernel where the gate passes and
    C_in <= ``max_cin`` (None: every width the gate admits)."""
    global _ENABLED, _MAX_CIN
    _ENABLED = bool(on)
    _MAX_CIN = max_cin


def _wide_plan(m: int, inner: int) -> WidePlan:
    (gc, gs), (oc, os_) = _WIDE["gate"], _WIDE["out"]
    m_tiles = -(-m // _WIDE_ROWS)

    def smem(weight_rows, stages):  # the ring and its barriers, 1024 bytes of slack
        return 1024 + stages * (_WIDE_ROWS + weight_rows) * 128 + 16 * stages

    gate_tiles, out_tiles = m_tiles * -(-inner // gc), m_tiles * (_WIDE_C // oc)
    return WidePlan(_WIDE_ROWS, gc, oc, gs, os_, smem(2 * gc, gs), smem(oc, os_),
                    gate_tiles, out_tiles, min(gate_tiles, SMS), min(out_tiles, SMS))


def _plan(m: int, c_in: int, inner: int, c_out: int, dtype):
    """The kernel's ``Plan`` (or ``WidePlan`` at C = 1280) of a call, or None
    where no kernel takes the shape."""
    if dtype != torch.bfloat16 or c_in != c_out or c_in not in (*_PLANS, _WIDE_C):
        return None
    if inner % 64 or not 0 < m < 2**31 // c_in:
        return None
    if c_in == _WIDE_C:
        return _wide_plan(m, inner)
    s1, s2, ping_pong = _PLANS[c_in]
    split = c_in == 640  # the consumers split y's columns, not its rows
    rows, step = (64, 2 * _SUB) if split else (128, _SUB)
    x_bytes, act_bytes = rows * c_in * 2, rows * 128 if split else 0
    smem = (1024 + x_bytes + act_bytes + s2 * c_in * 128 + s1 * 2 * step * 128
            + 8 * (1 + 2 * s1 + 2 * s2))
    return Plan(rows, _SUB, step, s1, s2, ping_pong and not split, smem, -(-m // rows))


def geglu_ff_supported(m: int, c_in: int, inner: int, c_out: int, dtype) -> bool:
    if not _ENABLED or (_MAX_CIN is not None and c_in > _MAX_CIN):
        return False
    return _plan(m, c_in, inner, c_out, dtype) is not None


def gelu_erf(x):
    if x.dtype == torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    return _gelu_exact(x)


def _gelu_exact(x):
    """The erf gelu on f32 internals, whatever the dtype."""
    xf = x.float()
    return (0.5 * xf * (1.0 + torch.erf(xf * 0.7071067811865476))).to(x.dtype)


def geglu_ff_unfused(x, w1, b1, w2, b2):
    """``FeedForward``'s arithmetic in x's dtype: Linear, ``gelu_erf`` gate,
    Linear. The kernels' gradients recompute through it."""
    h, gate = F.linear(x, w1, b1).chunk(2, dim=-1)
    return F.linear(h * gelu_erf(gate), w2, b2)


def geglu_ff_ln_unfused(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-5):
    return geglu_ff_unfused(layer_norm_plain(x, gamma, beta, eps), w1, b1, w2, b2)


def geglu_ff_plain(x, w1, b1, w2, b2):
    """The kernel's arithmetic: f32 accumulation in both products, a and g
    rounded to x's dtype, the erf gelu on f32 internals, one rounding of y."""
    inner = w2.shape[1]
    h = x.float() @ w1.float().t() + b1.float()
    a, g = h[:, :inner].to(x.dtype), h[:, inner:].to(x.dtype)
    act = a * _gelu_exact(g)
    return (act.float() @ w2.float().t() + b2.float()).to(x.dtype)


def geglu_ff_ln_plain(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-5):
    return geglu_ff_plain(layer_norm_plain(x, gamma, beta, eps), w1, b1, w2, b2)


def _check_cuda(x, w1, b1, w2, b2):
    if x.dim() != 2:
        raise ValueError(f"geglu_ff: x must be (M, C), got {tuple(x.shape)}")
    m, c_in = x.shape
    c_out, inner = w2.shape
    if w1.shape != (2 * inner, c_in) or b1.shape != (2 * inner,) or b2.shape != (c_out,):
        raise ValueError(
            f"geglu_ff: shapes x {tuple(x.shape)}, w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)}, "
            f"w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)}"
        )
    for t in (x, w1, b1, w2, b2):
        check_operand("geglu_ff", t, torch.bfloat16, x.device)
    plan = _plan(m, c_in, inner, c_out, x.dtype)
    if plan is None:
        raise ValueError(
            f"geglu_ff: no kernel takes (M, C_in, inner, C_out) = {(m, c_in, inner, c_out)}; "
            f"the kernels take C_in = C_out in {sorted((*_PLANS, _WIDE_C))} and inner a "
            f"multiple of 64"
        )
    return m, c_in, inner, plan


def _launch_wide(x, w1, b1, w2, b2, m, c, inner):
    """csrc/geglu_ff_wide.cu's two kernels, act in a scratch tensor between them."""
    act = torch.empty((m, inner), device=x.device, dtype=x.dtype)
    y = torch.empty_like(x)
    launch(
        "geglu_ff", "ctrlv_geglu_ff_wide_fwd", x.device,
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        act.data_ptr(), y.data_ptr(), m, c, inner,
    )
    return y


def _geglu_ff_cuda(x, w1, b1, w2, b2):
    m, c, inner, plan = _check_cuda(x, w1, b1, w2, b2)
    if plan.kernel == "wide":
        return _launch_wide(x, w1, b1, w2, b2, m, c, inner)
    y = torch.empty_like(x)
    launch(
        "geglu_ff", "ctrlv_geglu_ff_fwd", x.device,
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), y.data_ptr(),
        m, c, inner,
    )
    return y


def _geglu_ff_ln_cuda(x, gamma, beta, w1, b1, w2, b2, eps: float):
    m, c, inner, plan = _check_cuda(x, w1, b1, w2, b2)
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"geglu_ff_ln: norm parameters of shape {tuple(gamma.shape)} for {c}")
    # the kernels read gamma and beta as f32, as the TPU kernel does
    gamma32, beta32 = gamma.float().contiguous(), beta.float().contiguous()
    for p in (gamma32, beta32):
        check_operand("geglu_ff_ln", p, torch.float32, x.device)
    if plan.kernel == "wide":
        # LN(x) by K5's kernel into a scratch tensor: f32 fast-variance
        # statistics and f32 affine, one rounding (``layer_norm_plain``'s);
        # a part of this call, not a launch of layer_norm
        xn = torch.empty_like(x)
        launch(
            "geglu_ff_ln", "ctrlv_layer_norm_fwd", x.device,
            x.data_ptr(), gamma32.data_ptr(), beta32.data_ptr(), xn.data_ptr(),
            m, c, 0, eps, _ln_plan(m, c).blocks, count=False,
        )
        return _launch_wide(xn, w1, b1, w2, b2, m, c, inner)
    y = torch.empty_like(x)
    launch(
        "geglu_ff", "ctrlv_geglu_ff_ln_fwd", x.device,
        x.data_ptr(), gamma32.data_ptr(), beta32.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), y.data_ptr(), m, c, inner, ctypes.c_float(eps),
    )
    return y


def geglu_ff(x, w1, b1, w2, b2):
    """y = (a * gelu_erf(g)) W2^T + b2 with [a|g] = x W1^T + b1 over (M, C_in)
    rows; w1 (2*inner, C_in), w2 (C_out, inner), as ``nn.Linear`` keeps them."""
    if x.device.type == "cpu":
        return geglu_ff_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"geglu_ff: no kernel for device {x.device}")
    return with_recompute(_geglu_ff_cuda, geglu_ff_unfused, x, w1, b1, w2, b2)


def geglu_ff_ln(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-5):
    """``geglu_ff`` of LayerNorm(x): f32 fast-variance statistics, f32 affine."""
    if x.device.type == "cpu":
        return geglu_ff_ln_plain(x, gamma, beta, w1, b1, w2, b2, eps)
    if x.device.type != "cuda":
        raise ValueError(f"geglu_ff_ln: no kernel for device {x.device}")
    return with_recompute(
        lambda *t: _geglu_ff_ln_cuda(*t, eps),
        lambda *t: geglu_ff_ln_unfused(*t, eps),
        x, gamma, beta, w1, b1, w2, b2,
    )
