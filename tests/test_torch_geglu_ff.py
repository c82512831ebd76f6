"""The port's fused GEGLU feed-forward against the JAX package's.

The JAX side runs its Pallas kernels ``geglu_ff`` and ``geglu_ff_ln`` as its
own tests run them on the CPU: in interpret mode, with
``set_fused_geglu_ff(True)`` where the model's routing is under test (and
switched off again after). The port's wrappers take the kernel's plain
version for CPU tensors. Inputs are seeded numpy arrays. The JAX kernel
takes W1 as (C_in, 2*inner) and W2 as (inner, C_out); the port reads
``nn.Linear``'s transposes.

Tolerances, relative to the largest magnitude of the reference. f32: both
sides compute the same f32 arithmetic in another order of sums (the erf is a
polynomial on one side, torch's on the other, 1.5e-7 apart): 1e-4. bf16: a,
g, their product and y are each rounded to bf16 (2^-8 relative) and the
gradients pass through the unfused path's tanh gelu on the JAX side: 2e-2.
"""

import copy
import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctrlv_tpu.models import layers as jax_layers
from ctrlv_tpu_torch.models import layers
from ctrlv_tpu_torch.ops import _launch, geglu_ff as port_ff
from test_torch_convert import load

# the JAX package's ops/__init__ may shadow the module with its function
jax_ff = importlib.import_module("ctrlv_tpu.ops.geglu_ff")

torch.set_num_threads(1)

TOL = {False: 1e-4, True: 2e-2}
M, C, INNER = 256, 128, 512


@pytest.fixture
def jax_switch_on():
    jax_ff.set_fused_geglu_ff(True)
    try:
        yield
    finally:
        jax_ff.set_fused_geglu_ff(False)


def _operands(seed, ln):
    rng = np.random.default_rng(seed)
    ops = {
        "x": (1.5 * rng.standard_normal((M, C)) + (0.3 if ln else 0.0)),
        "w1": rng.standard_normal((C, 2 * INNER)) * 0.05,
        "b1": rng.standard_normal(2 * INNER) * 0.1,
        "w2": rng.standard_normal((INNER, C)) * 0.05,
        "b2": rng.standard_normal(C) * 0.1,
    }
    if ln:
        ops["lng"] = 1.0 + 0.2 * rng.standard_normal(C)
        ops["lnb"] = 0.1 * rng.standard_normal(C)
    r = rng.standard_normal((M, C))
    return {k: v.astype(np.float32) for k, v in ops.items()}, r.astype(np.float32)


def _close(out, ref, bf16, what):
    ref = np.asarray(ref, np.float32)
    out = np.asarray(out, np.float32)
    tol = TOL[bf16] * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out, ref, atol=tol, rtol=0, err_msg=what)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("ln", [False, True], ids=["ff", "ff_ln"])
def test_plain_matches_jax_kernel_values_and_gradients(ln, bf16):
    ops, r = _operands(int(ln) + 2 * int(bf16), ln)
    order = (["x", "lng", "lnb"] if ln else ["x"]) + ["w1", "b1", "w2", "b2"]
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    assert jax_ff._plan(M, C, INNER, C, 2 if bf16 else 4) is not None  # the Pallas kernel runs

    def jax_fn(*args):
        return jax_ff.geglu_ff_ln(*args, 1e-5) if ln else jax_ff.geglu_ff(*args)

    jargs = [jnp.asarray(ops[k], jdt) for k in order]
    ref = jax_fn(*jargs)
    ref_grads = jax.grad(lambda *a: jnp.sum(jax_fn(*a).astype(jnp.float32) * r),
                         tuple(range(len(order))))(*jargs)

    tdt = torch.bfloat16 if bf16 else torch.float32
    targs = {k: torch.from_numpy(ops[k]).to(tdt) for k in order}
    for k in ("w1", "w2"):  # nn.Linear keeps the transposes
        targs[k] = targs[k].t().contiguous()
    targs = {k: v.requires_grad_(True) for k, v in targs.items()}
    before = dict(_launch.LAUNCHES)
    fn = port_ff.geglu_ff_ln if ln else port_ff.geglu_ff
    out = fn(*[targs[k] for k in order], *((1e-5,) if ln else ()))
    assert _launch.LAUNCHES == before  # a CPU tensor takes the plain version, no launch
    assert out.dtype == tdt and out.shape == (M, C)
    _close(out.detach().float().numpy(), ref, bf16, "values")
    grads = torch.autograd.grad((out.float() * torch.from_numpy(r)).sum(),
                                [targs[k] for k in order])
    for k, g, g_ref in zip(order, grads, ref_grads):
        g = g.float().numpy()
        _close(g.T if k in ("w1", "w2") else g, g_ref, bf16, f"gradient of {k}")


def test_plain_repeats_the_kernels_roundings():
    """bf16: a, g and gelu(g) are rounded to bf16 before their product, and
    the gelu is the erf form; the unfused path's tanh form is at most one bf16
    ulp of act away."""
    ops, _ = _operands(9, False)
    x, w1, b1, w2, b2 = (torch.from_numpy(ops[k]).bfloat16() for k in ("x", "w1", "b1", "w2", "b2"))
    w1, w2 = w1.t().contiguous(), w2.t().contiguous()
    h = x.float() @ w1.float().t() + b1.float()
    a, g = h[:, :INNER].bfloat16(), h[:, INNER:].bfloat16()
    gelu = torch.nn.functional.gelu(g.float()).bfloat16()
    y = ((a * gelu).float() @ w2.float().t() + b2.float()).bfloat16()
    assert torch.equal(port_ff.geglu_ff_plain(x, w1, b1, w2, b2), y)
    unfused = port_ff.geglu_ff_unfused(x, w1, b1, w2, b2)
    _close(unfused.float().numpy(), y.float().numpy(), True, "unfused against fused")


def _ff_pair(dim, seed):
    """The JAX FeedForward with seeded params and the port's from them."""
    jmod = jax_layers.FeedForward(dim, dtype=jnp.float32)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.zeros((1, 128, dim)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        scale = leaf.shape[0] ** -0.5 if path[-1].key == "kernel" else 0.1
        return (scale * rng.standard_normal(leaf.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    return params, load(layers.FeedForward(dim), params)


@pytest.fixture(scope="module")
def ff_pair_320():
    """``_ff_pair(320, 3)``, built once for the module's cases."""
    return _ff_pair(320, 3)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_feed_forward_routes_like_jax_with_the_switch_on(jax_switch_on, ff_pair_320, bf16):
    """bf16 at C = 320: both packages route FeedForward to their fused kernel
    (the port's, on the CPU, to its plain version). f32: the JAX package
    still fuses, the port's gate refuses f32 and takes the unfused path."""
    dim = 320
    params, port = ff_pair_320[0], copy.deepcopy(ff_pair_320[1])
    x = np.random.default_rng(4).standard_normal((1, 128, dim)).astype(np.float32)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    assert jax_ff.geglu_ff_supported(128, dim, 4 * dim, dim, 2 if bf16 else 4)
    jmod = jax_layers.FeedForward(dim, dtype=jdt)
    ref = jmod.apply(params, jnp.asarray(x, jdt))

    tdt = torch.bfloat16 if bf16 else torch.float32
    port = port.to(tdt)
    xt = torch.from_numpy(x).to(tdt)
    calls = []
    real = layers.geglu_ff
    layers.geglu_ff = lambda *a: calls.append(a[0].shape) or real(*a)
    default = port_ff._ENABLED
    port_ff.set_fused_geglu_ff(True)
    try:
        assert port_ff.geglu_ff_supported(128, dim, 4 * dim, dim, tdt) is bf16
        with torch.no_grad():
            out = port(xt)
            with _launch.plain_kernels():
                plain = port(xt)
        port_ff.set_fused_geglu_ff(False)
        with torch.no_grad():
            off = port(xt)
    finally:
        layers.geglu_ff = real
        port_ff.set_fused_geglu_ff(default)
    assert calls == ([(128, dim)] if bf16 else [])  # flattened to (M, C), once
    assert out.shape == (1, 128, dim) and out.dtype == tdt
    assert torch.equal(plain, out)  # on the CPU the wrapper is its plain version
    _close(out.float().numpy(), ref, bf16, "switch on")
    _close(off.float().numpy(), ref, bf16, "switch off")
    if bf16:
        assert not torch.equal(off, out)  # erf against tanh gelu, other roundings


def test_feed_forward_takes_the_chain_where_a_gradient_is_wanted(ff_pair_320):
    """bf16 at C = 320, the switch on: the port's FeedForward calls the fused
    wrapper only where autograd wants no gradient of the call. Where it wants
    one (of a parameter or of x), the two Linears run, and the output is the
    JAX package's with its switch off."""
    params, port = ff_pair_320[0], copy.deepcopy(ff_pair_320[1]).to(torch.bfloat16)
    x = np.random.default_rng(5).standard_normal((1, 128, 320)).astype(np.float32)
    jmod = jax_layers.FeedForward(320, dtype=jnp.bfloat16)
    ref = jmod.apply(params, jnp.asarray(x, jnp.bfloat16))
    xt = torch.from_numpy(x).bfloat16()
    calls = []
    real = layers.geglu_ff
    layers.geglu_ff = lambda *a: calls.append(a[0].shape) or real(*a)
    try:
        assert port_ff.geglu_ff_supported(128, 320, 1280, 320, torch.bfloat16)
        with torch.no_grad():
            fused = port(xt)
        chain = port(xt)  # the parameters ask for a gradient
        port.requires_grad_(False)
        frozen = port(xt)
        chain_x = port(xt.clone().requires_grad_())
    finally:
        layers.geglu_ff = real
    assert calls == [(128, 320), (128, 320)]  # no_grad, and the frozen module
    assert chain.requires_grad and chain_x.requires_grad and not frozen.requires_grad
    assert torch.equal(frozen, fused) and torch.equal(chain.detach(), chain_x.detach())
    _close(chain.detach().float().numpy(), ref, True, "a gradient wanted")
    assert not torch.equal(chain.detach(), fused)  # tanh against erf gelu, other roundings


@pytest.mark.parametrize(
    "m,c_in,inner,c_out,dtype,expect",
    [
        (64000, 320, 1280, 320, torch.bfloat16, True),  # training, level 0
        (16000, 640, 2560, 640, torch.bfloat16, True),  # training, level 1
        (128000, 320, 1280, 320, torch.bfloat16, True),  # Box2Video step
        (32000, 640, 2560, 640, torch.bfloat16, True),
        (640000, 320, 1280, 320, torch.bfloat16, True),  # stage 1
        (999, 640, 2560, 640, torch.bfloat16, True),  # ragged M is masked, not refused
        (1, 320, 64, 320, torch.bfloat16, True),
        (4000, 1280, 5120, 1280, torch.bfloat16, False),  # a 320 KB accumulator: no block holds it
        (64000, 320, 1280, 320, torch.float32, False),
        (64000, 320, 1280, 320, torch.float16, False),
        (64000, 320, 1280, 640, torch.bfloat16, False),  # C_out != C_in
        (64000, 320, 1250, 320, torch.bfloat16, False),  # inner not a multiple of 64
        (64000, 128, 512, 128, torch.bfloat16, False),  # a width with no instantiation
        (0, 320, 1280, 320, torch.bfloat16, False),
        (2**31 // 320, 320, 1280, 320, torch.bfloat16, False),  # M*C overflows an int
    ],
)
def test_gate(m, c_in, inner, c_out, dtype, expect):
    assert (port_ff._plan(m, c_in, inner, c_out, dtype) is not None) is expect
    assert port_ff.geglu_ff_supported(m, c_in, inner, c_out, dtype) is expect  # on by default
    try:
        port_ff.set_fused_geglu_ff(False)
        assert not port_ff.geglu_ff_supported(m, c_in, inner, c_out, dtype)
    finally:
        port_ff.set_fused_geglu_ff(True)
    assert port_ff._ENABLED is True


def test_wrappers_reject_other_devices():
    x = torch.zeros(64, 320, device="meta", dtype=torch.bfloat16)
    w1, b1 = torch.zeros(2560, 320, device="meta"), torch.zeros(2560, device="meta")
    w2, b2 = torch.zeros(320, 1280, device="meta"), torch.zeros(320, device="meta")
    with pytest.raises(ValueError):
        port_ff.geglu_ff(x, w1, b1, w2, b2)
    with pytest.raises(ValueError):
        port_ff.geglu_ff_ln(x, b2, b2, w1, b1, w2, b2)


def test_unfused_is_the_modules_arithmetic():
    _, port = _ff_pair(64, 5)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((3, 7, 64)).astype(np.float32))
    proj, out = port.net[0].proj, port.net[2]
    with torch.no_grad():
        ref = port(x)
        got = port_ff.geglu_ff_unfused(x.reshape(21, 64), proj.weight, proj.bias, out.weight,
                                       out.bias)
    assert torch.equal(got.reshape(3, 7, 64), ref)


# (rows, width) -> (rows a block, inner columns of a first product, of a step,
# W1 stages, W2 stages, ping-pong, blocks): the six shapes the paths time, and
# ragged ones (one row, a part of the last tile)
PLANS = [
    ((64000, 320), (128, 32, 32, 8, 2, True, 500)),
    ((16000, 640), (64, 32, 64, 3, 1, False, 250)),
    ((128000, 320), (128, 32, 32, 8, 2, True, 1000)),
    ((32000, 640), (64, 32, 64, 3, 1, False, 500)),
    ((640000, 320), (128, 32, 32, 8, 2, True, 5000)),
    ((160000, 640), (64, 32, 64, 3, 1, False, 2500)),
    ((1, 320), (128, 32, 32, 8, 2, True, 1)),
    ((1001, 320), (128, 32, 32, 8, 2, True, 8)),
    ((999, 640), (64, 32, 64, 3, 1, False, 16)),
    ((129, 640), (64, 32, 64, 3, 1, False, 3)),
]


@pytest.mark.parametrize("shape,want", PLANS, ids=[str(s) for s, _ in PLANS])
def test_plan_table(shape, want):
    """The tiling as csrc/geglu_ff.cu has it: 128 rows a block at C = 320, 64
    at C = 640; it fits a block's shared memory, and the registers after
    setmaxnreg fit the SM's file."""
    m, c = shape
    plan = port_ff._plan(m, c, 4 * c, c, torch.bfloat16)
    assert tuple(plan[:6]) + (plan.blocks,) == want
    assert plan.blocks * plan.rows >= m > (plan.blocks - 1) * plan.rows
    assert plan.smem <= port_ff._SMEM_MAX
    assert 128 * (port_ff._PRODUCER_REGS + 2 * port_ff._CONSUMER_REGS) <= 65536


def test_plan_mirrors_the_source():
    """``_PLANS``, the first product's width and the register split are
    csrc/geglu_ff.cu's, and its shared-memory sum gives the same bytes."""
    text = (Path(port_ff.__file__).parents[1] / "csrc" / "geglu_ff.cu").read_text()
    for c, (s1, s2, ping_pong) in port_ff._PLANS.items():
        line = f"using Plan{c} = Cfg<{c}, {s1}, {s2}, {str(ping_pong).lower()}>;"
        assert text.count(line) == 1, line
    assert text.count(f"static constexpr int kSub = {port_ff._SUB};") == 1
    regs = dict(re.findall(r"constexpr int k(Producer|Consumer)Regs = (\d+);", text))
    assert (int(regs["Producer"]), int(regs["Consumer"])) == (
        port_ff._PRODUCER_REGS, port_ff._CONSUMER_REGS)
    # C = 320: x 80 KB, two W2 stages of 40 KB, eight W1 stages of 8 KB, 21 barriers
    assert port_ff._plan(64000, 320, 1280, 320, torch.bfloat16).smem == (
        1024 + 81920 + 2 * 40960 + 8 * 8192 + 8 * 21)
    # C = 640: x 80 KB, act 8 KB, one W2 stage of 80 KB, three W1 stages of 16 KB
    assert port_ff._plan(16000, 640, 2560, 640, torch.bfloat16).smem == (
        1024 + 81920 + 8192 + 81920 + 3 * 16384 + 8 * 9)


def test_ab_variants_patch_the_source():
    """Each design variant of ``tools/ab_geglu_ff.py`` still finds what it
    patches in csrc/geglu_ff.cu, once."""
    from ctrlv_tpu_torch.tools import ab_geglu_ff

    src = (ab_geglu_ff._build.CSRC / "geglu_ff.cu").read_text()
    for name, patches in ab_geglu_ff.VARIANTS.items():
        for old, _ in patches:
            assert src.count(old) == 1, (name, old)
