"""The gradient of the port's kernel wrappers: the shared recompute Function.

On a CUDA tensor that requires a gradient a wrapper launches its kernel
inside ``_launch._KernelFunction`` and differentiates its plain version in
the backward pass. Here, on the CPU, the plain version stands in for the
launch, so the Function itself, the per-head backward of the spatial
attention and ``needs_input_grad`` are all exercised, and the gradients are
held against plain autograd and against ``jax.grad`` of the JAX package's
``custom_vjp`` ops (their Pallas forwards in interpret mode) at real head
dims. The kernels' own backward runs are in tests/test_torch_cuda_kernels.py.

Tolerance: f32 on both sides, the same arithmetic in another order of sums:
1e-4 absolute on gradients of order 1.
"""

import importlib

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

import jax
import jax.numpy as jnp

from ctrlv_tpu.ops import flash_attention as jax_flash_mod
from ctrlv_tpu.ops import mha as jax_mha
from ctrlv_tpu_torch.ops import _launch, attention, group_norm, layer_norm, mha

jax_gn = importlib.import_module("ctrlv_tpu.ops.group_norm")
jax_ln = importlib.import_module("ctrlv_tpu.ops.layer_norm")
jax_flash = importlib.import_module("ctrlv_tpu.ops.flash_attention")

torch.set_num_threads(1)

ATOL = 1e-4


@pytest.fixture
def jax_norms_fused():
    jax_gn.set_fused_group_norm(True)
    jax_ln.set_fused_layer_norm(True)
    try:
        yield
    finally:
        jax_gn.set_fused_group_norm(False)
        jax_ln.set_fused_layer_norm(False)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _port_grads(plain, arrays, r, backward=None, requires=None):
    """Gradients of sum(out * r) through the Function, with ``plain`` standing
    in for the kernel's launch, and through plain autograd alone."""
    requires = requires or [True] * len(arrays)
    results = []
    for through_function in (True, False):
        ins = [torch.from_numpy(a.copy()).requires_grad_(n) for a, n in zip(arrays, requires)]
        launched = []

        def launch(*t):
            launched.append([x.requires_grad for x in t])
            return plain(*t)

        if through_function:
            out = _launch.with_recompute(launch, plain, *ins, backward=backward)
            assert type(out.grad_fn).__name__ == "_KernelFunctionBackward"
            assert len(launched) == 1
        else:
            out = plain(*ins)
        wanted = [t for t, n in zip(ins, requires) if n]
        grads = torch.autograd.grad((out * torch.from_numpy(r)).sum(), wanted)
        results.append([g.numpy() for g in grads])
    for a, b in zip(*results):
        np.testing.assert_allclose(a, b, atol=1e-6)
    return results[0]


def _check(grads, ref_grads):
    assert len(grads) == len(ref_grads)
    for i, (g, g_ref) in enumerate(zip(grads, ref_grads)):
        np.testing.assert_allclose(g, np.asarray(g_ref), atol=ATOL, err_msg=f"operand {i}")


def _jax_grads(fn, arrays, r):
    # jitted: the kernel's custom VJP in one XLA program, which compiles in a
    # fraction of the time the eager gradient takes
    return jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a) * r), tuple(range(len(arrays)))))(
        *(jnp.asarray(a) for a in arrays))


def test_mha_gradient_per_head_matches_jax():
    q, k, v, r = _arrays(0, *[(1, 1024, 128)] * 4)
    scale = 64**-0.5
    assert jax_mha.mha_supported(1024, 1024, 128, 2, 4)
    ref = _jax_grads(lambda *a: jax_mha.mha_attention(*a, 2, scale), [q, k, v], r)
    grads = _port_grads(lambda *t: mha.mha_attention_plain(*t, 2, scale), [q, k, v], r,
                        backward=mha.attention_backward_sliced(2, scale))
    _check(grads, ref)


def test_small_mha_gradient_matches_jax():
    q, k, v, r = _arrays(1, *[(256, 25, 128)] * 4)
    scale = 64**-0.5
    assert jax_mha.small_mha_supported(256, 25, 25, 128, 2, 4)
    ref = _jax_grads(lambda *a: jax_mha.small_mha_attention(*a, 2, scale), [q, k, v], r)
    _check(_port_grads(lambda *t: mha.small_mha_attention_plain(*t, 2, scale), [q, k, v], r), ref)


def test_small_mha_fm_gradient_matches_jax():
    f = 5
    q, k, v, r = _arrays(2, *[(2 * f, 128, 128)] * 4)
    scale = 64**-0.5
    assert jax_mha.small_mha_fm_supported(2 * f, 128, 128, 2, f, 4)
    ref = _jax_grads(lambda *a: jax_mha.small_mha_attention_fm(*a, 2, scale, f), [q, k, v], r)
    _check(_port_grads(lambda *t: mha.small_mha_attention_fm_plain(*t, 2, scale, f), [q, k, v], r),
           ref)


def test_flash_gradient_matches_jax():
    q, k, v, r = _arrays(3, *[(2, 128, 2, 64)] * 4)
    scale = 64**-0.5
    assert jax_flash._pick_block_q(128) > 0  # the Pallas kernel runs, in interpret mode
    ref = _jax_grads(lambda *a: jax_flash.flash_attention(*a, scale), [q, k, v], r)
    _check(_port_grads(lambda *t: attention.flash_attention_plain(*t, scale), [q, k, v], r), ref)


@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_gradient_matches_jax(jax_norms_fused, act):
    rng = np.random.default_rng(4)
    x = (1.5 * rng.standard_normal((2, 6, 5, 64)) + 0.3).astype(np.float32)  # channels-last
    gamma = (1.0 + 0.2 * rng.standard_normal(64)).astype(np.float32)
    beta = (0.2 * rng.standard_normal(64)).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)
    ref = _jax_grads(lambda *a: jax_gn.group_norm(*a, 8, 1e-6, act), [x, gamma, beta], r)
    to_first = lambda a: np.ascontiguousarray(a.transpose(0, 3, 1, 2))  # noqa: E731
    grads = _port_grads(lambda *t: group_norm.group_norm_plain(*t, 8, 1e-6, act),
                        [to_first(x), gamma, beta], to_first(r))
    grads[0] = grads[0].transpose(0, 2, 3, 1)
    _check(grads, ref)


def test_layer_norm_gradient_matches_jax(jax_norms_fused):
    rng = np.random.default_rng(5)
    x = (2.0 * rng.standard_normal((64, 320)) - 0.5).astype(np.float32)
    gamma = (1.0 + 0.2 * rng.standard_normal(320)).astype(np.float32)
    beta = (0.2 * rng.standard_normal(320)).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)
    ref = _jax_grads(lambda *a: jax_ln.layer_norm(*a, eps=1e-5), [x, gamma, beta], r)
    _check(_port_grads(lambda *t: layer_norm.layer_norm_plain(*t, 1e-5), [x, gamma, beta], r), ref)


@pytest.mark.parametrize("requires", [(True, False, False), (False, True, True),
                                      (False, False, True)])
def test_needs_input_grad_is_honoured(requires):
    """Only the inputs that ask for a gradient are differentiated: frozen
    weights cost no backward work and get None."""
    x, w, b, r = _arrays(6, (8, 64), (64,), (64,), (8, 64))
    seen = []

    def plain(*t):
        seen.append([a.requires_grad for a in t])
        return layer_norm.layer_norm_plain(*t, 1e-5)

    ins = [torch.from_numpy(a).requires_grad_(n) for a, n in zip((x, w, b), requires)]
    out = _launch.with_recompute(plain, plain, *ins)
    out.backward(torch.from_numpy(r))
    assert len(seen) == 2  # the launch, then one recompute
    assert seen[1] == list(requires)  # which differentiates what was asked for, no more
    for t, n in zip(ins, requires):
        assert (t.grad is not None) is n
    full = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
    layer_norm.layer_norm_plain(*full, 1e-5).backward(torch.from_numpy(r))
    for t, ref, n in zip(ins, full, requires):
        if n:
            torch.testing.assert_close(t.grad, ref.grad, atol=1e-6, rtol=0)


def test_per_head_backward_honours_needs_input_grad():
    q, k, v, r = _arrays(7, *[(1, 64, 128)] * 4)
    backward = mha.attention_backward_sliced(2, 0.125)
    grads = backward(torch.from_numpy(r), (False, True, False), *map(torch.from_numpy, (q, k, v)))
    assert grads[0] is None and grads[2] is None and grads[1].shape == k.shape
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    ref = torch.autograd.grad(mha.attention_plain(*ins, 2, 0.125), ins[1], torch.from_numpy(r))[0]
    torch.testing.assert_close(grads[1], ref, atol=1e-6, rtol=0)


def test_without_a_gradient_the_launch_is_direct():
    """No input requires a gradient, or none is being recorded: the wrapper
    launches as it always did, outside any autograd Function."""
    x, w, b = (torch.from_numpy(a) for a in _arrays(8, (8, 64), (64,), (64,)))
    calls = []

    def launch(*t):
        calls.append(t)
        return layer_norm.layer_norm_plain(*t, 1e-5)

    out = _launch.with_recompute(launch, None, x, w, b)
    assert out.grad_fn is None and not out.requires_grad
    assert calls[0][0] is x  # the very tensors, not saved copies
    with torch.no_grad():
        out = _launch.with_recompute(launch, None, x.clone().requires_grad_(True), w, b)
    assert out.grad_fn is None and len(calls) == 2


def test_checkpointing_reruns_the_launch_once():
    """Under torch.utils.checkpoint the forward runs again in the backward
    pass, so a checkpointed kernel is launched twice a step."""
    x, w, b, r = _arrays(9, (8, 64), (64,), (64,), (8, 64))
    launches = []

    def launch(*t):
        launches.append(1)
        return layer_norm.layer_norm_plain(*t, 1e-5)

    def block(x, w, b):
        return _launch.with_recompute(
            launch, lambda *t: layer_norm.layer_norm_plain(*t, 1e-5), x, w, b) * 2.0

    ins = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
    out = checkpoint(block, *ins, use_reentrant=False, preserve_rng_state=False)
    assert len(launches) == 1
    grads = torch.autograd.grad(out, ins, torch.from_numpy(r))
    assert len(launches) == 2
    ref_ins = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
    ref = torch.autograd.grad(layer_norm.layer_norm_plain(*ref_ins, 1e-5) * 2.0, ref_ins,
                              torch.from_numpy(r))
    for g, g_ref in zip(grads, ref):
        torch.testing.assert_close(g, g_ref, atol=1e-6, rtol=0)


def test_launch_counts_include_the_new_kernel():
    assert {"geglu_ff", "resblock"} <= set(_launch.LAUNCHES) and len(_launch.LAUNCHES) == 8
