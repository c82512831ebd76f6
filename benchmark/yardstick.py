"""The benchmark's own arithmetic: the card's peaks, the kinds of kernel,
the FLOPs of a unit of work and the least time of each attention and
feed-forward call, all from the plain reference models and the traffic's
shapes, never from the program.

FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode`` over the
reference models built on ``meta`` (as the program's ``tools/flops.py``
counts its own modules): matrix products, convolutions and attention.

The least time of a call is max(operations / peak, bytes / bandwidth), with
each input byte read once and each output byte written once, in the
configuration's dtype. A cross-attention to one key token is counted as the
operation it is: the value and output projections of the distinct context
rows (one CLIP token a clip), broadcast.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference import svd

# NVIDIA H100 SXM, dense: the bf16 tensor-core peak and the HBM3 bandwidth.
PEAK_FLOPS = {"bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12

# Kinds of device kernel by a word of the name the profiler reports; the
# first kind with a match wins. Copied from the program's
# ``tools/profile_denoise.py::KERNEL_KINDS``.
KERNEL_KINDS = (
    ("K2 + K3 (small_mha.cu)", ("small_mha_fwd_kernel",)),
    ("K1 + K8 (mha.cu)", ("mha_fwd_kernel",)),
    ("K7 (resblock.cu)", ("namespace)::conv_kernel", "namespace)::gn_sums_kernel",
                          "namespace)::relayout_kernel")),
    ("K4 (group_norm.cu)", ("namespace)::gn_",)),
    ("K5 (layer_norm.cu)", ("namespace)::ln_",)),
    ("K6 (geglu_ff.cu, geglu_ff_wide.cu)", ("geglu_ff_kernel", "geglu_ff_wide_kernel")),
    ("cuDNN NCHW<->NHWC transforms", ("nchwToNhwc", "nhwcToNchw")),
    ("convolutions (cuDNN)", ("cudnn", "implicit_gemm", "conv")),
    ("matmuls (cuBLAS)", ("nvjet", "gemm", "cutlass")),
    ("copies and casts", ("copy", "Memcpy", "CatArray")),
    ("softmax and reductions", ("softmax", "reduce")),
    ("elementwise (adds, muls, gelu, SiLU)", ("elementwise",)),
)


def kind_of(name: str) -> str:
    return next((k for k, words in KERNEL_KINDS if any(w in name for w in words)), "other")


@dataclasses.dataclass
class Site:
    """One call of an attention or feed-forward module: its kind, operations
    and bytes."""

    kind: str  # "attention" or "feed_forward"
    flops: float
    bytes: float

    def least_s(self, dtype: str = "bfloat16") -> float:
        return max(self.flops / PEAK_FLOPS[dtype], self.bytes / HBM_BYTES_PER_S)


def attention_site(m: svd.Attention, x_shape, ctx_shape, clips: int, elem: int) -> Site:
    """``clips``: the distinct CLIP tokens a one-token cross-attention reads."""
    b, sq, c = x_shape
    inner = m.heads * m.dim_head
    bias = inner * 3 if m.to_q.bias is not None else 0
    norm = 2 * c if m.group_norm is not None else 0
    if ctx_shape is not None and ctx_shape[1] == 1:
        cc = ctx_shape[-1]
        flops = 2.0 * clips * (cc * inner + inner * c)
        n = clips * cc + cc * inner + inner + inner * c + c + clips * c
        return Site("attention", flops, float(n * elem))
    sk, cc = (sq, c) if ctx_shape is None else (ctx_shape[1], ctx_shape[2])
    flops = 2.0 * b * (sq * c * inner + 2 * sk * cc * inner + 2 * sq * sk * inner + sq * inner * c)
    n = (b * sq * c + (0 if ctx_shape is None else b * sk * cc) + c * inner + 2 * cc * inner
         + inner * c + bias + c + norm + b * sq * c)
    return Site("attention", flops, float(n * elem))


def feed_forward_site(m: svd.FeedForward, x_shape, elem: int) -> Site:
    c = x_shape[-1]
    rows = 1
    for d in x_shape[:-1]:
        rows *= d
    inner = m.net[2].in_features
    flops = 2.0 * rows * (c * 2 * inner + inner * c)
    n = rows * c + c * 2 * inner + 2 * inner + inner * c + c + rows * c
    return Site("feed_forward", flops, float(n * elem))


def count(fn: Callable, models: dict, clips_of: Callable[[], int], elem: int = 2):
    """(FLOPs, [Site]) of ``fn()``, run on ``meta`` reference models: the
    FLOP counter's total and every attention and feed-forward call.
    ``clips_of()`` gives the CLIP tokens of the call in progress."""
    sites: List[Site] = []
    handles = []

    def on_attention(m, args, kwargs, out):
        ctx = args[1] if len(args) > 1 else kwargs.get("context")
        sites.append(attention_site(m, tuple(args[0].shape),
                                    None if ctx is None else tuple(ctx.shape), clips_of(), elem))

    def on_ff(m, args, out):
        sites.append(feed_forward_site(m, tuple(args[0].shape), elem))

    for model in models.values():
        for m in model.modules():
            if isinstance(m, svd.Attention):
                handles.append(m.register_forward_hook(on_attention, with_kwargs=True))
            elif isinstance(m, svd.FeedForward):
                handles.append(m.register_forward_hook(on_ff))
    try:
        with FlopCounterMode(display=False) as counter:
            fn()
    finally:
        for h in handles:
            h.remove()
    return float(counter.get_total_flops()), sites
