"""What the metrics' networks (the I3D of FVD, LPIPS's AlexNet) share: IEEE
f32 on the card, and a seeded random init for smoke runs.

cuDNN convolutions take f32 inputs through TF32 (a 10-bit mantissa) where
``torch.backends.cudnn.allow_tf32`` is set, which is PyTorch's default, and
cuBLAS matmuls do where ``torch.backends.cuda.matmul.allow_tf32`` is. A
metric is the reference's f32 metric, so the networks run inside
``ieee_f32()``, which turns both off for the block and puts them back after
it. (``torch.backends.cudnn.flags`` would also switch cuDNN off unless given
every other flag.)
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def ieee_f32():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@torch.no_grad()
def seeded_init_(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """flax's default init, drawn from a CPU generator seeded with ``seed``:
    kernels lecun-normal (std 1/sqrt(fan_in)), biases 0; the other
    parameters (norm scales) keep their init of 1. The same seed gives the
    same weights on every device. The draws are not JAX's: a random-weight
    metric is a smoke value, and differs between the two packages."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in module.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif p.dim() > 1:
            p.copy_(torch.randn(p.shape, generator=gen) * p[0].numel() ** -0.5)
    return module
