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


def _operands(seed, ln, m=M, c=C, inner=INNER):
    rng = np.random.default_rng(seed)
    ops = {
        "x": (1.5 * rng.standard_normal((m, c)) + (0.3 if ln else 0.0)),
        "w1": rng.standard_normal((c, 2 * inner)) * 0.05,
        "b1": rng.standard_normal(2 * inner) * 0.1,
        "w2": rng.standard_normal((inner, c)) * 0.05,
        "b2": rng.standard_normal(c) * 0.1,
    }
    if ln:
        ops["lng"] = 1.0 + 0.2 * rng.standard_normal(c)
        ops["lnb"] = 0.1 * rng.standard_normal(c)
    r = rng.standard_normal((m, c))
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
    # jitted: the Pallas kernel in interpret mode inside one XLA program, whose
    # gradient compiles in a fraction of the eager one's time
    ref_grads = jax.jit(jax.grad(lambda *a: jnp.sum(jax_fn(*a).astype(jnp.float32) * r),
                                 tuple(range(len(order)))))(*jargs)

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


# C = 1280: the width csrc/geglu_ff_wide.cu takes; 128 rows, which the JAX
# ``_plan`` tiles. Values in all four cases; the gradient in one (f32, at the
# tight tolerance), as the C = 128 cases above cover the gradient's arithmetic
# and each JAX gradient here costs seconds.
WIDE = (128, 1280, 5120)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("ln", [False, True], ids=["ff", "ff_ln"])
def test_plain_matches_jax_kernel_at_c1280(ln, bf16):
    m, c, inner = WIDE
    ops, r = _operands(10 + int(ln) + 2 * int(bf16), ln, m, c, inner)
    order = (["x", "lng", "lnb"] if ln else ["x"]) + ["w1", "b1", "w2", "b2"]
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    assert jax_ff._plan(m, c, inner, c, 2 if bf16 else 4) is not None  # the Pallas kernel runs
    assert port_ff._plan(m, c, inner, c, torch.bfloat16).kernel == "wide"
    grad = not (ln or bf16)

    def jax_fn(*args):
        return jax_ff.geglu_ff_ln(*args, 1e-5) if ln else jax_ff.geglu_ff(*args)

    jargs = [jnp.asarray(ops[k], jdt) for k in order]
    targs = {k: torch.from_numpy(ops[k]).to(tdt) for k in order}
    for k in ("w1", "w2"):  # nn.Linear keeps the transposes
        targs[k] = targs[k].t().contiguous().requires_grad_(grad)
    fn = port_ff.geglu_ff_ln if ln else port_ff.geglu_ff
    out = fn(*[targs[k] for k in order], *((1e-5,) if ln else ()))
    assert out.dtype == tdt and out.shape == (m, c)
    if not grad:
        _close(out.float().numpy(), jax_fn(*jargs), bf16, "values")
        return
    ref, vjp = jax.vjp(jax.jit(jax_fn), *jargs)  # jitted, as above
    _close(out.detach().numpy(), ref, bf16, "values")
    ref_grads = vjp(jnp.asarray(r))
    grads = torch.autograd.grad((out * torch.from_numpy(r)).sum(), [targs["w1"], targs["w2"]])
    for k, g in zip(("w1", "w2"), grads):
        _close(g.numpy().T, ref_grads[order.index(k)], bf16, f"gradient of {k}")


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


def _routes_like_jax(params, port, dim, bf16, seed, max_cin=None):
    """Both packages' FeedForward on the same input with their switches on (the
    port's with ``max_cin``), each against the JAX output; returns whether each
    package routes the call, the calls of the port's fused wrapper, and its
    outputs with the switch on and off."""
    x = np.random.default_rng(seed).standard_normal((1, 128, dim)).astype(np.float32)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    jax_routed = jax_ff.geglu_ff_supported(128, dim, 4 * dim, dim, 2 if bf16 else 4)
    ref = jax_layers.FeedForward(dim, dtype=jdt).apply(params, jnp.asarray(x, jdt))

    tdt = torch.bfloat16 if bf16 else torch.float32
    port = port.to(tdt)
    xt = torch.from_numpy(x).to(tdt)
    calls = []
    real = layers.geglu_ff
    layers.geglu_ff = lambda *a: calls.append(a[0].shape) or real(*a)
    default = port_ff._ENABLED, port_ff._MAX_CIN
    port_ff.set_fused_geglu_ff(True, max_cin)
    try:
        routed = port_ff.geglu_ff_supported(128, dim, 4 * dim, dim, tdt)
        with torch.no_grad():
            out = port(xt)
            with _launch.plain_kernels():
                plain = port(xt)
        port_ff.set_fused_geglu_ff(False)
        with torch.no_grad():
            off = port(xt)
    finally:
        layers.geglu_ff = real
        port_ff.set_fused_geglu_ff(*default)
    assert out.shape == (1, 128, dim) and out.dtype == tdt
    assert torch.equal(plain, out)  # on the CPU the wrapper is its plain version
    _close(out.float().numpy(), ref, bf16, "switch on")
    _close(off.float().numpy(), ref, bf16, "switch off")
    return jax_routed, routed, calls, out, off


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_feed_forward_routes_like_jax_with_the_switch_on(jax_switch_on, ff_pair_320, bf16):
    """bf16 at C = 320: both packages route FeedForward to their fused kernel
    (the port's, on the CPU, to its plain version). f32: the JAX package
    still fuses, the port's gate refuses f32 and takes the unfused path."""
    params, port = ff_pair_320[0], copy.deepcopy(ff_pair_320[1])
    jax_routed, routed, calls, out, off = _routes_like_jax(params, port, 320, bf16, 4)
    assert jax_routed and routed is bf16
    assert calls == ([(128, 320)] if bf16 else [])  # flattened to (M, C), once
    if bf16:
        assert not torch.equal(off, out)  # erf against tanh gelu, other roundings


def test_feed_forward_1280_routes_like_jax_with_the_switch_on(jax_switch_on):
    """bf16 at C = 1280 (csrc/geglu_ff_wide.cu's width): both packages route
    FeedForward to their fused kernel; with ``max_cin`` 640 neither does (the
    JAX package's ``set_fused_geglu_ff(True, max_cin=640)``), and the port's
    output is its unfused path's, bit for bit."""
    params, port = _ff_pair(1280, 7)
    jax_routed, routed, calls, out, off = _routes_like_jax(params, port, 1280, True, 8)
    assert jax_routed and routed and calls == [(128, 1280)]
    assert not torch.equal(off, out)
    jax_ff.set_fused_geglu_ff(True, max_cin=640)
    jax_routed, routed, calls, out, off = _routes_like_jax(params, port, 1280, True, 8, 640)
    assert not jax_routed and not routed and calls == [] and torch.equal(out, off)


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
        (4000, 1280, 5120, 1280, torch.bfloat16, True),  # training: csrc/geglu_ff_wide.cu
        (64000, 320, 1280, 320, torch.float32, False),
        (64000, 320, 1280, 320, torch.float16, False),
        (64000, 320, 1280, 640, torch.bfloat16, False),  # C_out != C_in
        (64000, 320, 1250, 320, torch.bfloat16, False),  # inner not a multiple of 64
        (64000, 128, 512, 128, torch.bfloat16, False),  # a width with no instantiation
        (0, 320, 1280, 320, torch.bfloat16, False),
        (2**31 // 320, 320, 1280, 320, torch.bfloat16, False),  # M*C overflows an int
        # C = 1280: the Box2Video step (M = 8000, and 2000 in the mid block), stage 1,
        # the legacy UNet2D, one row, a ragged last tile, half a gate tile of inner
        (8000, 1280, 5120, 1280, torch.bfloat16, True),
        (2000, 1280, 5120, 1280, torch.bfloat16, True),
        (40000, 1280, 5120, 1280, torch.bfloat16, True),
        (10000, 1280, 5120, 1280, torch.bfloat16, True),
        (512, 1280, 5120, 1280, torch.bfloat16, True),
        (128, 1280, 5120, 1280, torch.bfloat16, True),
        (1, 1280, 64, 1280, torch.bfloat16, True),
        (1001, 1280, 1344, 1280, torch.bfloat16, True),
        (4000, 1280, 5120, 1280, torch.float32, False),
        (4000, 1280, 5120, 640, torch.bfloat16, False),  # C_out != C_in
        (4000, 1280, 5000, 1280, torch.bfloat16, False),  # inner not a multiple of 64
        (4000, 960, 3840, 960, torch.bfloat16, False),  # a width with no kernel
        (2**31 // 1280, 1280, 5120, 1280, torch.bfloat16, False),  # M*C overflows an int
    ],
)
def test_gate(m, c_in, inner, c_out, dtype, expect):
    """The gate, a pure function of shape and dtype, and the routing: the
    switch, and ``max_cin`` (None: every admitted width; 640: none at 1280)."""
    assert (port_ff._plan(m, c_in, inner, c_out, dtype) is not None) is expect
    default = port_ff.DEFAULT_MAX_CIN
    assert port_ff._MAX_CIN == default
    assert port_ff.geglu_ff_supported(m, c_in, inner, c_out, dtype) is (  # on by default
        expect and (default is None or c_in <= default))
    try:
        port_ff.set_fused_geglu_ff(True, max_cin=None)
        assert port_ff.geglu_ff_supported(m, c_in, inner, c_out, dtype) is expect
        port_ff.set_fused_geglu_ff(True, max_cin=640)
        assert port_ff.geglu_ff_supported(m, c_in, inner, c_out, dtype) is (expect and c_in <= 640)
        port_ff.set_fused_geglu_ff(False)
        assert not port_ff.geglu_ff_supported(m, c_in, inner, c_out, dtype)
    finally:
        port_ff.set_fused_geglu_ff(True)
    assert port_ff._ENABLED is True and port_ff._MAX_CIN == default


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
    # C = 1280 (rows a tile, gate and out tile columns and stages, their tiles and
    # their persistent grids): the Box2Video step, stage 1, training, the legacy
    # UNet2D, one row, a ragged last tile
    ((8000, 1280), (128, 128, 160, 4, 6, 2520, 504, 132, 132)),
    ((2000, 1280), (128, 128, 160, 4, 6, 640, 128, 132, 128)),
    ((40000, 1280), (128, 128, 160, 4, 6, 12520, 2504, 132, 132)),
    ((10000, 1280), (128, 128, 160, 4, 6, 3160, 632, 132, 132)),
    ((4000, 1280), (128, 128, 160, 4, 6, 1280, 256, 132, 132)),
    ((512, 1280), (128, 128, 160, 4, 6, 160, 32, 132, 32)),
    ((128, 1280), (128, 128, 160, 4, 6, 40, 8, 40, 8)),
    ((1, 1280), (128, 128, 160, 4, 6, 40, 8, 40, 8)),
    ((1001, 1280), (128, 128, 160, 4, 6, 320, 64, 132, 64)),
]


@pytest.mark.parametrize("shape,want", PLANS, ids=[str(s) for s, _ in PLANS])
def test_plan_table(shape, want):
    """The tiling as csrc/geglu_ff.cu has it: 128 rows a block at C = 320, 64
    at C = 640; and as csrc/geglu_ff_wide.cu has it at C = 1280: tiles of 128
    rows, persistent grids of at most one block an SM. It fits a block's shared
    memory, the registers after setmaxnreg fit the SM's file, and it is the
    kernel's, whatever the routing (``max_cin``)."""
    m, c = shape
    plan = port_ff._plan(m, c, 4 * c, c, torch.bfloat16)
    if plan.kernel == "wide":
        assert tuple(plan[:5]) + tuple(plan[7:11]) == want
        assert plan.gate_tiles * plan.gate_cols >= 4 * c * -(-m // plan.rows)
        assert max(plan.gate_smem, plan.out_smem) <= port_ff._SMEM_MAX
    else:
        assert tuple(plan[:6]) + (plan.blocks,) == want
        assert plan.blocks * plan.rows >= m > (plan.blocks - 1) * plan.rows
        assert plan.smem <= port_ff._SMEM_MAX
    assert 128 * (port_ff._PRODUCER_REGS + 2 * port_ff._CONSUMER_REGS) <= 65536
    try:
        port_ff.set_fused_geglu_ff(True, max_cin=640)
        assert port_ff._plan(m, c, 4 * c, c, torch.bfloat16) == plan
    finally:
        port_ff.set_fused_geglu_ff(True)


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


def test_wide_plan_mirrors_the_source():
    """``_WIDE`` and the rows of a tile are csrc/geglu_ff_wide.cu's, its
    register split is geglu_ff.cu's, and its shared-memory sum gives the same
    bytes."""
    text = (Path(port_ff.__file__).parents[1] / "csrc" / "geglu_ff_wide.cu").read_text()
    (gc, gs), (oc, os_) = port_ff._WIDE["gate"], port_ff._WIDE["out"]
    assert text.count(f"using GateTile = Wide<true, {gc}, {gs}>;") == 1
    assert text.count(f"using OutTile = Wide<false, {oc}, {os_}>;") == 1
    assert text.count(f"constexpr int kBM = {port_ff._WIDE_ROWS};") == 1
    assert text.count(f"constexpr int kWideC = {port_ff._WIDE_C};") == 1
    regs = dict(re.findall(r"constexpr int k(Producer|Consumer)Regs = (\d+);", text))
    assert (int(regs["Producer"]), int(regs["Consumer"])) == (
        port_ff._PRODUCER_REGS, port_ff._CONSUMER_REGS)
    plan = port_ff._plan(8000, 1280, 5120, 1280, torch.bfloat16)
    # gate: four stages of x's 128 rows and W1's 256 (a's and g's); out: six of act's
    # 128 rows and W2's 160; 128-byte rows, two barriers a stage
    assert plan.gate_smem == 1024 + 4 * (128 + 256) * 128 + 8 * 8
    assert plan.out_smem == 1024 + 6 * (128 + 160) * 128 + 8 * 12


def test_ab_variants_patch_the_source():
    """Each design variant of ``tools/ab_geglu_ff.py`` still finds what it
    patches in csrc/geglu_ff.cu, once."""
    from ctrlv_tpu_torch.tools import ab_geglu_ff

    src = (ab_geglu_ff._build.CSRC / "geglu_ff.cu").read_text()
    for name, patches in ab_geglu_ff.VARIANTS.items():
        for old, _ in patches:
            assert src.count(old) == 1, (name, old)
