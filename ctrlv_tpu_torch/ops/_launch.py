"""What the kernel wrappers share: the launch counts, the all-plain switch,
operand checks, the ctypes call and the kernels' gradient.

Each wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel and
nowhere else, so a run can show that its path went through the kernels.
``plain_kernels()`` makes the model modules call every kernel's plain
version instead, for comparing the two on the card; each of the newer
kernels also has a switch of its own in its module.

No kernel has a backward kernel, as none of the TPU kernels has one: each is
a ``jax.custom_vjp`` that recomputes through its plain reference.
``with_recompute`` is the counterpart. Where an input requires a gradient
the kernel runs inside a ``torch.autograd.Function`` that saves the inputs;
its backward runs the plain version again on detached inputs, with the
gradient enabled, and differentiates that. Where nothing requires a
gradient the kernel is launched directly.
"""

from __future__ import annotations

import contextlib

import torch

from . import _build

LAUNCHES = {
    "mha": 0, "small_mha": 0, "small_mha_fm": 0, "flash": 0, "group_norm": 0, "layer_norm": 0,
    "geglu_ff": 0, "resblock": 0,
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


def check_tma_operands(name: str, row_elems: int, *tensors) -> None:
    """Raise unless a TMA copy can read each of ``tensors`` as rows of
    ``row_elems`` elements: it needs a 16-byte aligned base and a row stride
    that is a multiple of 16 bytes. The C entry of ``csrc/mha.cu`` refuses
    the same."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: base address {t.data_ptr():#x} is not 16-byte aligned")
        if row_elems * t.element_size() % 16:
            raise ValueError(f"{name}: row stride of {row_elems * t.element_size()} bytes is not "
                             f"a multiple of 16")


_resolved: tuple = (None, {})  # the library in use and its C functions by name


def c_function(fn_name: str):
    """The C entry point ``fn_name`` of the kernel library in use (built at
    first use), resolved once per library."""
    global _resolved
    lib = _build._lib or _build.load()
    if _resolved[0] is not lib:
        _resolved = (lib, {})
    fns = _resolved[1]
    fn = fns.get(fn_name)
    if fn is None:
        fn = fns[fn_name] = getattr(lib, fn_name)
    return fn


def launch(name: str, fn_name: str, device, *args, count: bool = True) -> None:
    """Call the C entry point ``fn_name(*args, stream)`` on ``device``'s
    current stream; raise on a cudaError, else count one launch of ``name``
    (``count=False``: a helper of the kernel, such as a weight re-layout).
    The device is made current only where it is not already."""
    fn = c_function(fn_name)
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")
    if count:
        LAUNCHES[name] += 1


def recompute_backward(plain):
    """A backward that differentiates ``plain(*inputs)``:
    ``(grad_out, needs, *inputs) -> one gradient or None per input``."""

    def backward(grad_out, needs, *inputs):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
            out = plain(*ins)
        wanted = [t for t, n in zip(ins, needs) if n]
        grads = iter(torch.autograd.grad(out, wanted, grad_out.to(out.dtype)))
        return tuple(next(grads) if n else None for n in needs)

    return backward


class _KernelFunction(torch.autograd.Function):
    """``launch(*inputs)`` forwards; ``backward(grad, needs, *inputs)`` gives
    the gradients of the inputs that need one."""

    @staticmethod
    def forward(ctx, launch_fn, backward_fn, *inputs):
        ctx.backward_fn = backward_fn
        ctx.save_for_backward(*inputs)
        return launch_fn(*inputs)

    @staticmethod
    def backward(ctx, grad_out):
        needs = ctx.needs_input_grad[2:]
        grads = ctx.backward_fn(grad_out.contiguous(), needs, *ctx.saved_tensors)
        return (None, None, *grads)


def with_recompute(launch_fn, plain, *inputs, backward=None):
    """``launch_fn(*inputs)``, with a gradient where an input requires one:
    ``backward`` if given, else the gradient of ``plain(*inputs)``,
    recomputed in the backward pass. ``inputs`` are the tensor operands;
    anything else is bound into the two functions by the caller."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _KernelFunction.apply(launch_fn, backward or recompute_backward(plain), *inputs)
    return launch_fn(*inputs)
