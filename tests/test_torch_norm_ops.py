"""The port's GroupNorm(+SiLU) and LayerNorm ops against the JAX package's.

The JAX side runs its Pallas kernels as its own tests run them on the CPU:
switched on (``set_fused_group_norm`` / ``set_fused_layer_norm``) and in
interpret mode. The port's wrappers take their plain versions for CPU
tensors. Inputs are seeded numpy arrays; the JAX package is channels-last,
the port channels-first, so the test transposes.

Tolerances. f32: both sides compute the same f32 arithmetic in another
order of sums, 1e-5 absolute on outputs of order 1. bf16: both round the f32
result once, so they differ by at most one bf16 ulp of the output (2^-7
relative), plus 1e-6 absolute where the affine cancels to nearly zero.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ctrlv_tpu_torch.models import layers
from ctrlv_tpu_torch.ops import _launch, group_norm, layer_norm

# the JAX package's ops/__init__ shadows these two modules with their functions
jax_gn = importlib.import_module("ctrlv_tpu.ops.group_norm")
jax_ln = importlib.import_module("ctrlv_tpu.ops.layer_norm")

torch.set_num_threads(1)

BF16_RTOL, BF16_ATOL = 2.0**-7, 1e-6
F32_ATOL = 1e-5


@pytest.fixture
def jax_fused():
    """The JAX package's two norm kernels switched on, and off again after."""
    jax_gn.set_fused_group_norm(True)
    jax_ln.set_fused_layer_norm(True)
    try:
        yield
    finally:
        jax_gn.set_fused_group_norm(False)
        jax_ln.set_fused_layer_norm(False)


def _check(out, ref, bf16):
    if bf16:
        np.testing.assert_allclose(out, ref, rtol=BF16_RTOL, atol=BF16_ATOL)
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=F32_ATOL)


def _to(x, bf16):
    """numpy f32 -> (torch tensor, jax array) in the working dtype."""
    t = torch.from_numpy(x)
    j = jnp.asarray(x)
    return (t.bfloat16(), j.astype(jnp.bfloat16)) if bf16 else (t, j)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("spatial", [(6, 5), (3, 4, 5)], ids=["4d", "5d"])
def test_group_norm_matches_jax_kernel(jax_fused, spatial, act, bf16):
    rng = np.random.default_rng(len(spatial) + 10 * bf16)
    b, c, groups = 2, 64, 8
    x = (1.5 * rng.standard_normal((b, *spatial, c)) + 0.3).astype(np.float32)  # channels-last
    gamma = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.2 * rng.standard_normal(c)).astype(np.float32)
    xt, xj = _to(x, bf16)
    ref = jax_gn.group_norm(xj, jnp.asarray(gamma), jnp.asarray(beta), groups, 1e-6, act)
    assert ref.dtype == xj.dtype
    perm = (0, len(spatial) + 1) + tuple(range(1, len(spatial) + 1))
    inv = (0,) + tuple(range(2, len(spatial) + 2)) + (1,)
    before = dict(_launch.LAUNCHES)
    out = group_norm.group_norm(
        xt.permute(perm).contiguous(), torch.from_numpy(gamma), torch.from_numpy(beta),
        groups, 1e-6, act,
    )
    assert out.dtype == xt.dtype
    assert _launch.LAUNCHES == before  # a CPU tensor takes the plain version, no launch
    _check(out.permute(inv).float().numpy(), np.asarray(ref.astype(jnp.float32)), bf16)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(64, 320), (3, 8, 128), (257, 64)])
def test_layer_norm_matches_jax_kernel(jax_fused, shape, bf16):
    rng = np.random.default_rng(shape[0] + bf16)
    x = (2.0 * rng.standard_normal(shape) - 0.5).astype(np.float32)
    gamma = (1.0 + 0.2 * rng.standard_normal(shape[-1])).astype(np.float32)
    beta = (0.2 * rng.standard_normal(shape[-1])).astype(np.float32)
    xt, xj = _to(x, bf16)
    ref = jax_ln.layer_norm(xj, jnp.asarray(gamma), jnp.asarray(beta), eps=1e-5)
    out = layer_norm.layer_norm(xt, torch.from_numpy(gamma), torch.from_numpy(beta), 1e-5)
    assert out.dtype == xt.dtype and out.shape == xt.shape
    _check(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), bf16)


def test_norm_plain_versions_match_torch_functional():
    """The plain versions compute torch's own norms (another variance
    algorithm, so f32 rounding apart)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 64, 5, 7)).astype(np.float32))
    w = torch.from_numpy((1 + 0.1 * rng.standard_normal(64)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.standard_normal(64)).astype(np.float32))
    ref = torch.nn.functional.silu(torch.nn.functional.group_norm(x, 32, w, b, 1e-6))
    out = group_norm.group_norm_plain(x, w, b, 32, 1e-6, "silu")
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=F32_ATOL)
    rows = x.permute(0, 2, 3, 1)
    ref = torch.nn.functional.layer_norm(rows, (64,), w, b, 1e-5)
    np.testing.assert_allclose(
        layer_norm.layer_norm_plain(rows, w, b, 1e-5).numpy(), ref.numpy(), atol=F32_ATOL
    )


def test_constant_input_has_zero_variance_not_nan():
    """E[x^2] - E[x]^2 can round below zero; both norms clamp it."""
    x = torch.full((1, 32, 4, 4), 3.0000001)
    ones, zeros = torch.ones(32), torch.zeros(32)
    assert torch.isfinite(group_norm.group_norm(x, ones, zeros, 32, 1e-6)).all()
    assert torch.isfinite(layer_norm.layer_norm(x.reshape(16, 32), ones, zeros, 1e-5)).all()


@pytest.mark.parametrize(
    "shape,groups,dtype,pdtype,expect",
    [
        ((50, 320, 40, 64), 32, torch.bfloat16, torch.bfloat16, True),  # UNet level 0
        ((2, 320, 25, 40, 64), 32, torch.bfloat16, torch.bfloat16, True),  # temporal ResBlock
        ((24, 128, 320, 512), 32, torch.bfloat16, torch.float32, True),  # VAE decoder, f32 affine
        ((3, 512, 2560), 32, torch.bfloat16, torch.bfloat16, True),  # VAE attention, (B, C, S)
        ((2, 33, 7, 9), 3, torch.bfloat16, torch.bfloat16, True),  # run of 693: no alignment asked
        ((50, 320, 40, 64), 32, torch.float32, torch.float32, False),  # f32 activations
        ((50, 320, 40, 64), 32, torch.bfloat16, torch.float16, False),
        ((2, 48, 8, 8), 32, torch.bfloat16, torch.bfloat16, False),  # C not a multiple of G
        ((2, 32, 0, 8), 32, torch.bfloat16, torch.bfloat16, False),  # empty
        ((64,), 32, torch.bfloat16, torch.bfloat16, False),
    ],
)
def test_group_norm_gate(shape, groups, dtype, pdtype, expect):
    assert group_norm.group_norm_supported(shape, groups, dtype, pdtype) is expect


@pytest.mark.parametrize(
    "shape,dtype,pdtype,expect",
    [
        ((128000, 320), torch.bfloat16, torch.bfloat16, True),  # the three widths of the UNet
        ((50, 640, 640), torch.bfloat16, torch.bfloat16, True),
        ((8000, 1280), torch.bfloat16, torch.float32, True),
        ((257, 2048), torch.bfloat16, torch.bfloat16, True),  # odd row count, widest row
        ((128000, 320), torch.float32, torch.float32, False),  # f32 activations
        ((16, 2056), torch.bfloat16, torch.bfloat16, False),  # above 2048
        ((16, 36), torch.bfloat16, torch.bfloat16, False),  # not a multiple of 8
        ((0, 320), torch.bfloat16, torch.bfloat16, False),  # no rows
        ((16, 320), torch.bfloat16, torch.float16, False),
    ],
)
def test_layer_norm_gate(shape, dtype, pdtype, expect):
    assert layer_norm.layer_norm_supported(shape, dtype, pdtype) is expect


def test_switches_default_on_and_restore():
    assert group_norm._FUSED_GN and layer_norm._FUSED_LN
    try:
        group_norm.set_fused_group_norm(False)
        layer_norm.set_fused_layer_norm(False)
        assert not group_norm._FUSED_GN and not layer_norm._FUSED_LN
    finally:
        group_norm.set_fused_group_norm(True)
        layer_norm.set_fused_layer_norm(True)


def test_wrappers_reject_other_devices_and_unknown_act():
    x = torch.zeros(2, 32, 4, 4, device="meta")
    p = torch.zeros(32, device="meta")
    with pytest.raises(ValueError):
        group_norm.group_norm(x, p, p, 32, 1e-6)
    with pytest.raises(ValueError):
        layer_norm.layer_norm(x.reshape(32, 32), p, p, 1e-5)
    with pytest.raises(ValueError):
        group_norm.group_norm(torch.zeros(2, 32, 4, 4), torch.ones(32), torch.zeros(32), 32,
                              1e-6, act="relu")


def test_modules_fuse_silu_and_follow_the_plain_switch():
    """GroupNorm(act="silu") is silu(GroupNorm); under plain_kernels() the
    modules call the plain versions (the same values on the CPU)."""
    torch.manual_seed(0)
    x = torch.randn(2, 64, 6, 6)
    gn = layers.GroupNorm(32, 64, 1e-5)
    gn_silu = layers.GroupNorm(32, 64, 1e-5, act="silu")
    with torch.no_grad():
        for m in (gn, gn_silu):
            m.weight.normal_(1.0, 0.1)
        gn_silu.weight.copy_(gn.weight)
        ref = torch.nn.functional.silu(gn(x))
        torch.testing.assert_close(gn_silu(x), ref, atol=1e-6, rtol=0)
        ln = layers.LayerNorm(64)
        rows = x.permute(0, 2, 3, 1).reshape(-1, 64)
        with _launch.plain_kernels():
            assert _launch.plain_selected()
            plain_gn, plain_ln = gn_silu(x), ln(rows)
        assert not _launch.plain_selected()
        assert torch.equal(plain_gn, gn_silu(x)) and torch.equal(plain_ln, ln(rows))
