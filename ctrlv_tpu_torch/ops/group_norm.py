"""GroupNorm with an optional SiLU over channels-first (B, C, *spatial)
tensors: the plain version, the kernel and its plan.

Counterpart of ``ctrlv_tpu/ops/group_norm.py``. ``group_norm`` replaces the
Pallas kernel ``ctrlv_tpu/ops/group_norm.py::group_norm`` (``_gn_kernel``)
with ``csrc/group_norm.cu``: f32 sum and sum of squares per (sample, group),
variance E[x^2] - E[x]^2 clamped at 0, ``rsqrt(var + eps)``, the affine and
the optional SiLU in f32, one rounding to the output dtype. The JAX package
is channels-last and needs a one-hot group map; here one (sample, group) is
one contiguous run of (C/G) * prod(spatial) elements.

``_plan`` picks the kernel's path per shape, a pure function of it (the
source's header says what each path does):

- ``short``: runs whose items fit a ring of at least two buffers in shared
  memory, read once by a persistent grid through 1-D bulk copies;
- ``cluster``: longer runs that fit the shared memory of a cluster of at most
  16 CTAs, read once and summed across the cluster in distributed shared
  memory;
- ``two_pass``: runs beyond a cluster, and runs or channels that do not start
  on a 16-byte boundary, read twice.

A CPU tensor takes the plain version. A CUDA tensor whose shape and dtype
pass ``group_norm_supported`` launches the kernel or raises, while the
switch is on; other CUDA tensors (f32 activations, C not a multiple of the
group count) take the plain version by the gate.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from ._launch import c_function, check_operand, launch, with_recompute

SMS = 132  # the H100's SMs, for the persistent grid and the waves a plan prints
# Shared memory: a block may have 232,448 bytes, an SM 233,472 of which the
# system keeps 1 KB a block. The kernel's own layout (csrc/group_norm.cu, the
# same numbers): a header of 1 KB, then a table of (scale, shift) a channel,
# then the data, each part rounded up to 128 bytes.
SMEM_BLOCK, SMEM_SM, SMEM_RESERVED = 232_448, 233_472, 1024
HEADER, THREADS, SPLIT_THREADS = 1024, 256, 512
MAX_STAGES, CHUNK, MAX_CHUNKS, MAX_CLUSTER = 8, 8192, 16, 16
# The numbers below won the A/B on the card (tools/ab_norms.py; PERF.md, Findings).
# The short path takes runs of which two fit a block at 2 blocks an SM; it
# packs them into items of up to this many bytes (1, 2, 4 or 8 runs an item)
# and keeps up to 4 items in flight a block, at up to this many blocks an SM.
# The cluster path takes the smallest cluster whose slices hold at most this
# many elements, else the largest that fits. The two-pass path cuts a run
# into slices of this many elements, at most this many (every block adds all
# of its run's partial sums, so more slices than that cost more than they
# spread).
SHORT_ITEM_BYTES, SHORT_STAGES, SHORT_CTAS = 32 * 1024, 4, 4
CLUSTER_SLICE = 20 * 1024
SPLIT_ELEMS, MAX_SPLITS = 16 * 1024, 64
PATHS = ("short", "cluster", "two_pass")

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


@dataclass(frozen=True)
class Plan:
    """A launch of the kernel: ``path``; ``n`` runs an item (short), CTAs a
    cluster (cluster) or slices a run (two_pass); ``stages`` item buffers a
    block (short); the grid of ``blocks`` (two_pass: of each kernel; cluster:
    the CTAs of all runs, of which the kernel launches as many clusters as
    the card holds at once, each walking runs);
    ``smem`` bytes of dynamic shared memory a block; ``ctas_per_sm``, the
    blocks an SM holds at once by shared memory and threads."""

    path: str
    n: int
    stages: int
    blocks: int
    smem: int
    ctas_per_sm: int

    @property
    def waves(self) -> float:
        return self.blocks / (SMS * self.ctas_per_sm)


def _r128(nbytes: int) -> int:
    return -(-nbytes // 128) * 128


def _per_sm(smem: int, threads: int) -> int:
    return min(SMEM_SM // (smem + SMEM_RESERVED), 2048 // threads)


def _dims(shape, num_groups: int):
    """(runs, run, spatial, channels per group) of x of ``shape``."""
    spatial = 1
    for d in shape[2:]:
        spatial *= d
    cpg = shape[1] // num_groups
    return shape[0] * num_groups, cpg * spatial, spatial, cpg


def cluster_slice(run: int, cs: int) -> int:
    """Elements of a run that one CTA of a cluster of ``cs`` holds."""
    return (-(-run // cs) + 7) // 8 * 8


def short_plan(runs, run, spatial, cpg, ctas=SHORT_CTAS, item_bytes=SHORT_ITEM_BYTES,
               min_stages=None) -> Optional[Plan]:
    """The short-run path with ``ctas`` blocks an SM, fewer where the ring
    would hold fewer than ``min_stages`` items (by default 2, and 1 where the
    grid has fewer than 8 items an SM: there one buffer a block at 4 blocks an
    SM beat two at 2 on the card, PERF.md); or None."""
    if run % 8 or spatial % 8:
        return None
    k = 1
    while k < 8 and 2 * k * 2 * run <= item_bytes:
        k *= 2
    if min_stages is None:
        min_stages = 1 if -(-runs // k) < 8 * SMS else 2
    table, stage = _r128(8 * k * cpg), _r128(2 * k * run)
    for c in range(ctas, 0, -1):
        budget = min(SMEM_BLOCK, SMEM_SM // c - SMEM_RESERVED)
        stages = min(SHORT_STAGES, (budget - HEADER - table) // stage)
        if stages >= min_stages:
            smem = HEADER + table + stages * stage
            items = -(-runs // k)
            return Plan("short", k, stages, min(items, SMS * c), smem, _per_sm(smem, THREADS))
    return None


def cluster_plan(runs, run, spatial, cpg, cs=None, min_cs=1) -> Optional[Plan]:
    """The cluster path: ``cs`` CTAs a run, or the smallest cluster of at
    least ``min_cs`` whose slices hold at most CLUSTER_SLICE elements, else
    16; None where it does not fit."""
    if run % 8 or spatial % 8 or runs * (cs or MAX_CLUSTER) >= 2**31:
        return None
    sizes = (cs,) if cs else [s for s in (1, 2, 4, 8, 16) if s >= min_cs]
    for size in sizes:
        slice_ = cluster_slice(run, size)
        if cs or slice_ <= CLUSTER_SLICE or size == sizes[-1]:
            smem = HEADER + _r128(8 * cpg) + _r128(2 * slice_)
            if smem > SMEM_BLOCK or slice_ > MAX_CHUNKS * CHUNK:
                return None
            return Plan("cluster", size, 0, runs * size, smem, _per_sm(smem, THREADS))
    return None


def two_pass_plan(runs, run, spatial, cpg) -> Plan:
    splits = min(MAX_SPLITS, -(-run // SPLIT_ELEMS))
    return Plan("two_pass", splits, 0, runs * splits, 0, 2048 // SPLIT_THREADS)


def plan_for(path: str, shape, num_groups: int) -> Optional[Plan]:
    """``path``'s plan for x of ``shape``, taken as far as it can be (a short
    run ring of one buffer, a cluster of 2 to 16 CTAs, so that the CTAs add
    each other's sums); None where it cannot."""
    dims = _dims(shape, num_groups)
    if path == "short":
        return short_plan(*dims, min_stages=1)
    if path == "cluster":
        return cluster_plan(*dims, min_cs=2)
    if path == "two_pass":
        return two_pass_plan(*dims)
    raise ValueError(f"group_norm: no path {path!r}")


def clusters_at_once(plan: Plan) -> int:
    """Clusters of a cluster ``plan`` that the card holds at once
    (cudaOccupancyMaxActiveClusters, as the kernel's launch checks it)."""
    out = ctypes.c_int(0)
    rc = c_function("ctrlv_group_norm_clusters")(plan.n, plan.smem, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"group_norm: cudaOccupancyMaxActiveClusters failed with {rc}")
    return out.value


def two_runs_fit(run: int, cpg: int) -> bool:
    """Whether two runs fit a block at 2 blocks an SM: the short path's runs."""
    return HEADER + _r128(8 * cpg) + 2 * _r128(2 * run) <= SMEM_SM // 2 - SMEM_RESERVED


@functools.lru_cache(maxsize=256)
def _plan(shape: tuple, num_groups: int) -> Plan:
    """The path for x of ``shape``: short runs through the persistent ring,
    else one cluster a run, else two passes."""
    dims = _dims(shape, num_groups)
    short = two_runs_fit(dims[1], dims[3]) and short_plan(*dims)
    return short or cluster_plan(*dims) or two_pass_plan(*dims)


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


def _group_norm_cuda(x, weight, bias, num_groups: int, eps: float, act: Optional[str],
                     plan: Optional[Plan] = None):
    """The kernel on ``plan``, by default ``_plan``'s for x's shape."""
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
    runs, run, spatial, cpg = _dims(x.shape, num_groups)
    plan = plan or _plan(tuple(x.shape), num_groups)
    out = torch.empty_like(x)
    scratch = None
    if plan.path == "two_pass":
        scratch = torch.empty((runs * plan.n * 2,), dtype=torch.float32, device=x.device)
    launch(
        "group_norm", "ctrlv_group_norm_fwd", x.device,
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
        0 if scratch is None else scratch.data_ptr(), runs, run, spatial, cpg, num_groups,
        PATHS.index(plan.path), plan.n, plan.stages, plan.blocks, plan.smem,
        int(weight.dtype == torch.bfloat16), int(act == "silu"), eps,
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
        # a gradient recomputes through the plain version (fast variance)
        return with_recompute(
            lambda *t: _group_norm_cuda(*t, num_groups, eps, act),
            lambda *t: group_norm_plain(*t, num_groups, eps, act),
            x, weight, bias,
        )
    return group_norm_plain(x, weight, bias, num_groups, eps, act)
