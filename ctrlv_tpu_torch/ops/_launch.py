"""What the kernel wrappers share: the launch counts, the all-plain switch,
operand checks and the ctypes call.

Each wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel and
nowhere else, so a run can show that its path went through the kernels.
``plain_kernels()`` makes the model modules call every kernel's plain
version instead, for comparing the two on the card; each of the newer
kernels also has a switch of its own in its module.
"""

from __future__ import annotations

import contextlib

import torch

LAUNCHES = {
    "mha": 0, "small_mha": 0, "small_mha_fm": 0, "flash": 0, "group_norm": 0, "layer_norm": 0,
}
_plain = False


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def plain_kernels():
    """Inside this block, the model modules take the kernels' plain versions."""
    global _plain
    prev, _plain = _plain, True
    try:
        yield
    finally:
        _plain = prev


def plain_selected() -> bool:
    return _plain


def check_operand(name: str, t, dtype, device=None) -> None:
    """Raise unless ``t`` is what a kernel reads: a contiguous, 16-byte
    aligned CUDA tensor of ``dtype`` (on ``device``, when given)."""
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name}: operand on {t.device}, expected {device or 'cuda'}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: the kernel takes {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: operand of shape {tuple(t.shape)} is not contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: operand not 16-byte aligned")


def launch(name: str, fn_name: str, device, *args) -> None:
    """Call the C entry point ``fn_name(*args, stream)`` on ``device``'s
    current stream; raise on a cudaError, else count one launch of ``name``."""
    from ._build import load

    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")
    LAUNCHES[name] += 1
