"""The port's fused spatial ResBlock (K7) against the JAX package's.

The same seeded numpy inputs go through ``ctrlv_tpu.ops.resblock``'s Pallas
kernel (interpret mode on the CPU, as tests/test_resblock.py runs it) and its
XLA reference, and through the port's plain version, which is what the
wrapper computes for a CPU tensor and what the CUDA kernel is held against on
the card (tests/test_torch_cuda_kernels.py, chip_smoke.py).

Layouts. The JAX function takes x (N, H, W, C) and weights (3, 3, C_in,
C_out); the port takes x (N, C, H, W) and ``nn.Conv2d``'s (C_out, C_in, 3, 3):

    x_port = x_jax.transpose(0, 3, 1, 2)     w_port = w_jax.transpose(3, 2, 0, 1)

Tolerances, as tests/test_resblock.py has them: f32 5e-5 (the same
arithmetic in another order of sums), bf16 5e-2 (outputs of order 1-4, a bf16
ulp there is up to 3e-2); gradients in f32 to 2e-4 + 1e-3 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctrlv_tpu.models.resnet import ResnetBlock2D as JaxResnetBlock2D
from ctrlv_tpu.ops import resblock as jax_resblock
from ctrlv_tpu_torch.models.resnet import ResnetBlock2D
from ctrlv_tpu_torch.ops import _launch, plain_kernels, resblock
from test_torch_convert import load, seeded_params

torch.set_num_threads(1)

NAMES = ("x", "g1", "b1", "w1", "wb1", "temb", "g2", "b2", "w2", "wb2")


def inputs(n, h, w, c, seed=0):
    """The ten operands in the JAX layout, f32."""
    rng = np.random.default_rng(seed)
    normal = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    wscale = 1.0 / np.sqrt(9 * c)
    return [normal(n, h, w, c), 1.0 + 0.2 * normal(c), 0.1 * normal(c),
            wscale * normal(3, 3, c, c), 0.1 * normal(c), normal(n, c),
            1.0 + 0.2 * normal(c), 0.1 * normal(c), wscale * normal(3, 3, c, c), 0.1 * normal(c)]


def to_port(args, dtype=torch.float32):
    """JAX-layout numpy operands -> the port's tensors: x to NCHW, weights to OIHW."""
    out = []
    for name, a in zip(NAMES, args):
        if name == "x":
            a = a.transpose(0, 3, 1, 2)
        elif name in ("w1", "w2"):
            a = a.transpose(3, 2, 0, 1)
        out.append(torch.from_numpy(np.ascontiguousarray(a)).to(dtype))
    return out


def grads_to_jax_layout(grads):
    out = []
    for name, g in zip(NAMES, grads):
        g = g.numpy()
        if name == "x":
            g = g.transpose(0, 2, 3, 1)
        elif name in ("w1", "w2"):
            g = g.transpose(2, 3, 1, 0)
        out.append(g)
    return out


@pytest.mark.parametrize("dtype,jdtype,atol", [(torch.float32, jnp.float32, 5e-5),
                                               (torch.bfloat16, jnp.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("ref", ["kernel", "reference"])
def test_plain_matches_jax(dtype, jdtype, atol, ref):
    args = inputs(2, 8, 16, 64)
    jargs = [jnp.asarray(a) for a in args]
    jargs[0] = jargs[0].astype(jdtype)  # as tests/test_resblock.py: x in the working dtype
    fn = jax_resblock.fused_resblock2d if ref == "kernel" else jax_resblock._reference_resblock
    want = np.asarray(fn(*jargs, 8, 1e-6), np.float32)
    pargs = to_port(args)
    pargs[0] = pargs[0].to(dtype)
    got = resblock.fused_resblock2d(*pargs, 8, 1e-6)  # a CPU tensor: the plain version
    assert got.dtype == dtype and got.shape == (2, 64, 8, 16)
    np.testing.assert_allclose(got.float().numpy().transpose(0, 2, 3, 1), want, atol=atol)


def test_plain_rounds_where_the_kernel_rounds():
    """All operands bf16, as the model hands them over: h is rounded once,
    after bias and temb were added in f32, and GN2 sees the rounded h."""
    pargs = to_port(inputs(1, 8, 8, 64, seed=3), torch.bfloat16)
    x, g1, b1, w1, wb1, temb, g2, b2, w2, wb2 = pargs
    got = resblock.fused_resblock2d_plain(*pargs, 8, 1e-5)
    gn = lambda z, g, b: torch.nn.functional.silu(  # noqa: E731
        torch.nn.functional.group_norm(z.float(), 8, g.float(), b.float(), 1e-5)).bfloat16()
    conv = lambda z, w: torch.nn.functional.conv2d(z.float(), w.float(), padding=1)  # noqa: E731
    h = (conv(gn(x, g1, b1), w1) + (wb1.float() + temb.float())[:, :, None, None]).bfloat16()
    want = (conv(gn(h, g2, b2), w2) + wb2.float()[None, :, None, None] + x.float()).bfloat16()
    # the two-pass variance of F.group_norm against E[x^2] - E[x]^2: a bf16 ulp here and there
    assert (got.float() - want.float()).abs().max() <= 2.0**-5
    assert (got == want).float().mean() > 0.98


def test_boundary_impulses_match_jax():
    """Zero padding of 1: impulses at the four corners and the centre reach
    every border tap."""
    n, h, w, c = 1, 8, 16, 64
    args = inputs(n, h, w, c)
    x = np.zeros((n, h, w, c), np.float32)
    for i, j in [(0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1), (h // 2, w // 2)]:
        x[0, i, j, :] = 1.0
    args[0] = x
    want = np.asarray(jax_resblock.fused_resblock2d(*[jnp.asarray(a) for a in args], 8, 1e-6))
    got = resblock.fused_resblock2d(*to_port(args), 8, 1e-6)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, atol=5e-5)


def _jax_grads(args, r):
    fn = lambda *a: jnp.sum(jax_resblock.fused_resblock2d(*a, 8, 1e-6) * r)  # noqa: E731
    # jitted: one XLA program, which compiles faster than the eager gradient runs
    return jax.jit(jax.grad(fn, tuple(range(10))))(*[jnp.asarray(a) for a in args])


@pytest.fixture(scope="module")
def ten_operands():
    """Inputs, cotangent and the JAX gradients of the ten-operand case, once
    for both of its routes."""
    args = inputs(1, 8, 8, 64, seed=1)
    r = np.random.default_rng(2).standard_normal((1, 8, 8, 64)).astype(np.float32)
    return args, r, _jax_grads(args, r)


@pytest.mark.parametrize("through_function", [False, True], ids=["autograd", "recompute"])
def test_gradients_of_all_ten_operands_match_jax(ten_operands, through_function):
    """The JAX function is a custom_vjp that recomputes through its XLA
    reference; the port's wrapper differentiates its plain version, here with
    the plain version standing in for the launch too."""
    args, r, want = ten_operands
    ins = [t.requires_grad_(True) for t in to_port(args)]
    plain = lambda *t: resblock.fused_resblock2d_plain(*t, 8, 1e-6)  # noqa: E731
    if through_function:
        launched = []

        def launch(*t):
            launched.append(1)
            return plain(*t)

        out = _launch.with_recompute(launch, plain, *ins)
        assert type(out.grad_fn).__name__ == "_KernelFunctionBackward" and len(launched) == 1
    else:
        out = resblock.fused_resblock2d(*ins, 8, 1e-6)
    r_port = torch.from_numpy(np.ascontiguousarray(r.transpose(0, 3, 1, 2)))
    grads = torch.autograd.grad((out * r_port).sum(), ins)
    for name, g, g_ref in zip(NAMES, grads_to_jax_layout(grads), want):
        np.testing.assert_allclose(g, np.asarray(g_ref), atol=2e-4, rtol=1e-3, err_msg=name)


def test_recompute_skips_frozen_operands():
    """A frozen UNet: only x and temb ask for a gradient; the weights get None
    and the recompute differentiates nothing else."""
    ins = to_port(inputs(1, 8, 8, 64, seed=4))
    needs = [name in ("x", "temb") for name in NAMES]
    ins = [t.requires_grad_(n) for t, n in zip(ins, needs)]
    seen = []

    def plain(*t):
        seen.append([a.requires_grad for a in t])
        return resblock.fused_resblock2d_plain(*t, 8, 1e-6)

    out = _launch.with_recompute(plain, plain, *ins)
    out.sum().backward()
    assert seen[1] == needs
    assert [t.grad is not None for t in ins] == needs
    full = [t.detach().clone().requires_grad_(True) for t in ins]
    resblock.fused_resblock2d_plain(*full, 8, 1e-6).sum().backward()
    torch.testing.assert_close(ins[0].grad, full[0].grad, atol=1e-6, rtol=0)
    torch.testing.assert_close(ins[5].grad, full[5].grad, atol=1e-6, rtol=0)


# (N, C, H, W, groups, dtype) -> admitted
GATE = [
    ((50, 320, 40, 64, 32, torch.bfloat16), True),   # what the JAX gate admits: level 0
    ((25, 320, 40, 64, 32, torch.bfloat16), True),
    ((250, 320, 40, 64, 32, torch.bfloat16), True),
    ((50, 640, 20, 32, 32, torch.bfloat16), True),   # the deeper same-channel blocks
    ((50, 1280, 10, 16, 32, torch.bfloat16), True),  # ragged last tile of 8 image rows
    ((50, 1280, 5, 8, 32, torch.bfloat16), True),
    ((3, 320, 11, 16, 32, torch.bfloat16), True),
    ((50, 320, 40, 64, 32, torch.float32), False),   # bf16 only
    ((50, 960, 20, 32, 32, torch.bfloat16), False),  # group size 30 does not divide 160
    ((50, 64, 16, 16, 8, torch.bfloat16), False),    # not a multiple of 320
    ((50, 320, 40, 24, 32, torch.bfloat16), False),  # W does not divide 128
    ((50, 320, 40, 4, 32, torch.bfloat16), False),   # W below 8
    ((50, 320, 40, 256, 32, torch.bfloat16), False),  # W above a tile
    ((70000, 320, 40, 64, 32, torch.bfloat16), False),  # beyond the grid and int32 offsets
    ((50, 320, 40, 64, 7, torch.bfloat16), False),   # groups do not divide C
]


@pytest.mark.parametrize("shape,admitted", GATE, ids=[str(s[:5]) for s, _ in GATE])
def test_gate_is_a_pure_function_of_shape_and_dtype(shape, admitted):
    assert (resblock._plan(*shape) is not None) is admitted
    assert not resblock.resblock_supported(*shape)  # off by default
    resblock.set_fused_resblock(True)
    try:
        assert resblock.resblock_supported(*shape) is admitted
    finally:
        resblock.set_fused_resblock(False)


def test_gate_admits_what_the_jax_gate_admits():
    jax_resblock.set_fused_resblock(True)
    try:
        assert jax_resblock.resblock_supported(2560, 320, 32, 2)
    finally:
        jax_resblock.set_fused_resblock(False)
    plan = resblock._plan(50, 320, 40, 64, 32, torch.bfloat16)
    assert (plan.rows, plan.tiles, plan.cblocks) == (2, 1000, 1)
    plan = resblock._plan(50, 1280, 10, 16, 32, torch.bfloat16)
    assert (plan.rows, plan.tiles, plan.max_seg, plan.cblocks) == (8, 63, 2, 4)


@pytest.fixture
def routed(monkeypatch):
    """K7's switch on, and its gate opened to the small f32 shapes of a CPU test."""
    monkeypatch.setattr(resblock, "_plan", lambda *a: (1, 1, 1))
    resblock.set_fused_resblock(True)
    yield
    resblock.set_fused_resblock(False)


def _seeded_block(cin, cout, temb_channels, eps=1e-5):
    block = ResnetBlock2D(cin, cout, temb_channels, eps=eps)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, p in block.named_parameters():
            p.normal_(0.0, 0.1 if p.dim() == 1 else p[0].numel() ** -0.5, generator=gen)
            if "norm" in name and name.endswith("weight"):
                p.add_(1.0)
    return block


def test_module_routes_to_the_fused_function(routed):
    """The switch on against the switch off, f32: the fused function rounds
    once where the module rounds twice, which f32 does not see."""
    block = _seeded_block(64, 64, 32)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 64, 8, 16)).astype(np.float32))
    temb = torch.from_numpy(rng.standard_normal((2, 32)).astype(np.float32))
    calls = []
    keep = resblock.fused_resblock2d_plain

    def spy(*a):
        calls.append(a)
        return keep(*a)

    import ctrlv_tpu_torch.models.resnet as resnet_mod

    with torch.no_grad():
        fused = block(x, temb)
        resblock.set_fused_resblock(False)
        unfused = block(x, temb)
        resblock.set_fused_resblock(True)
        resnet_mod.fused_resblock2d_plain, saved = spy, resnet_mod.fused_resblock2d_plain
        try:
            with plain_kernels():
                via_plain = block(x, temb)
        finally:
            resnet_mod.fused_resblock2d_plain = saved
    torch.testing.assert_close(fused, unfused, atol=1e-4, rtol=0)
    assert len(calls) == 1 and calls[0][-2:] == (32, 1e-5)  # groups and the module's own eps
    torch.testing.assert_close(via_plain, fused, atol=0, rtol=0)


@pytest.mark.parametrize("case", ["shortcut", "no-temb", "no-proj"])
def test_module_keeps_the_unfused_path(routed, monkeypatch, case):
    """A 1x1 shortcut (every up-block ResBlock), no time embedding, or no
    projection (the VAE's ResBlocks): the fused function is not called."""
    import ctrlv_tpu_torch.models.resnet as resnet_mod

    def boom(*a):
        raise AssertionError("routed to the fused function")

    monkeypatch.setattr(resnet_mod, "fused_resblock2d", boom)
    monkeypatch.setattr(resnet_mod, "fused_resblock2d_plain", boom)
    cin = 32 if case == "shortcut" else 64
    block = _seeded_block(cin, 64, None if case == "no-proj" else 32)
    x = torch.randn(1, cin, 8, 8, generator=torch.Generator().manual_seed(0))
    temb = None if case != "shortcut" else torch.randn(1, 32)
    with torch.no_grad():
        assert block(x, temb).shape == (1, 64, 8, 8)


def test_routed_module_matches_the_jax_module(routed):
    """The port's ResnetBlock2D with K7 on against the JAX ResnetBlock2D from
    the same (converted) weights."""
    jblock = JaxResnetBlock2D(in_channels=64, out_channels=64, temb_channels=32, eps=1e-5)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 8, 16, 64)).astype(np.float32)
    temb = rng.standard_normal((2, 32)).astype(np.float32)
    params = seeded_params(jblock, 8, jnp.asarray(x), jnp.asarray(temb))
    want = np.asarray(jblock.apply(params, jnp.asarray(x), jnp.asarray(temb)))
    block = load(ResnetBlock2D(64, 64, 32, eps=1e-5), params)
    with torch.no_grad():
        got = block(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))),
                    torch.from_numpy(temb))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, atol=1e-4, rtol=1e-4)


def test_launch_counter_and_exports():
    from ctrlv_tpu_torch import ops

    assert "resblock" in _launch.LAUNCHES
    assert ops.fused_resblock2d is resblock.fused_resblock2d
    assert ops.set_fused_resblock is resblock.set_fused_resblock
    before = dict(_launch.LAUNCHES)
    resblock.fused_resblock2d(*to_port(inputs(1, 8, 8, 64)), 8, 1e-6)
    assert dict(_launch.LAUNCHES) == before  # the plain version counts no launch


# (N, C, H, W) -> (image rows a tile, tiles, samples a tile at most, output
# channels a block, blocks, padding share): the 12 shapes chip_smoke.py times.
PLANS = [
    ((50, 320, 40, 64), (2, 1000, 1, 320, 1000, 0.0)),
    ((25, 320, 40, 64), (2, 500, 1, 320, 500, 0.0)),
    ((250, 320, 40, 64), (2, 5000, 1, 320, 5000, 0.0)),
    ((50, 640, 20, 32), (4, 250, 1, 320, 500, 0.0)),
    ((50, 1280, 10, 16), (8, 63, 2, 320, 252, 1 - 500 / 504)),
    ((50, 1280, 5, 8), (16, 16, 4, 160, 128, 1 - 250 / 256)),
    ((25, 640, 20, 32), (4, 125, 1, 320, 250, 0.0)),
    ((25, 1280, 10, 16), (8, 32, 2, 160, 256, 1 - 250 / 256)),  # 128 blocks of 320: too few
    ((25, 1280, 5, 8), (16, 8, 4, 160, 64, 1 - 125 / 128)),
    ((250, 640, 20, 32), (4, 1250, 1, 320, 2500, 0.0)),
    ((250, 1280, 10, 16), (8, 313, 2, 320, 1252, 1 - 2500 / 2504)),
    ((250, 1280, 5, 8), (16, 79, 4, 320, 316, 1 - 1250 / 1264)),
]


@pytest.mark.parametrize("shape,want", PLANS, ids=[str(s) for s, _ in PLANS])
def test_plan_table(shape, want):
    """The tiling as csrc/resblock.cu's make_plan has it: 128-pixel tiles of
    whole image rows over all samples (only the call's last tile is ragged),
    320 output channels a block where that leaves a block for every SM."""
    plan = resblock._plan(*shape, 32, torch.bfloat16)
    rows, tiles, max_seg, width, blocks, padding = want
    assert (plan.rows, plan.tiles, plan.max_seg, 160 * plan.halves, plan.blocks) == (
        rows, tiles, max_seg, width, blocks)
    assert plan.padding == pytest.approx(padding, abs=1e-12)
    assert plan.smem <= 232448 - 1024 and 2 <= plan.stages <= 4
    n, _, h, w = shape
    assert plan.tiles * plan.rows >= n * h > (plan.tiles - 1) * plan.rows


def test_plan_fits_every_admitted_shape():
    """The worst staging of the gate's shapes: W = 8 and one-row images, so a
    tile holds 16 samples, each with two halo rows; it still fits."""
    plan = resblock._plan(64, 1280, 1, 8, 32, torch.bfloat16)
    assert (plan.max_seg, plan.slots, plan.halves) == (16, 480, 1)
    assert plan.smem <= 232448 - 1024


def _permute_relayout(w):
    """The kernel's re-layout, (C_out, C_in, 3, 3) -> (9, C_out, C_in), on the CPU."""
    return w.detach().permute(2, 3, 0, 1).reshape(9, *w.shape[:2]).clone()


def _cache_and_weight(seed=0, c=8):
    cache = resblock.RelaidWeights(_permute_relayout)
    w = torch.nn.Parameter(torch.randn(c, c, 3, 3, generator=torch.Generator().manual_seed(seed)))
    return cache, w


def test_weight_cache_relays_a_frozen_weight_once():
    cache, w = _cache_and_weight()
    first = cache(w)
    for _ in range(3):
        assert cache(w) is first
    assert cache.relayouts == 1
    torch.testing.assert_close(first[4], w.detach()[:, :, 1, 1], atol=0, rtol=0)


@pytest.mark.parametrize("write", ["copy_", "adamw", "load_state_dict"])
def test_weight_cache_relays_after_an_update(write):
    """Every way the port writes a weight bumps its version: a fresh copy."""
    from ctrlv_tpu_torch.train import make_optimizer

    cache, w = _cache_and_weight()
    old = cache(w)
    if write == "copy_":
        with torch.no_grad():
            w.copy_(torch.randn_like(w))
    elif write == "adamw":
        tx = make_optimizer(learning_rate=1e-2, nan_guard_steps=0)
        state = tx.init({"w": w})
        tx.update({"w": torch.ones_like(w)}, state, {"w": w})
    else:
        conv = torch.nn.Conv2d(8, 8, 3, padding=1, bias=False)
        conv.weight = w
        conv.load_state_dict({"weight": torch.randn(8, 8, 3, 3)})
    new = cache(w)
    assert cache.relayouts == 2 and new is not old
    torch.testing.assert_close(new, _permute_relayout(w), atol=0, rtol=0)
    assert cache(w) is new


def test_weight_cache_knows_tensors_apart():
    """Another tensor of the same shape is not served the first one's copy,
    and a copy goes with its tensor."""
    cache, w = _cache_and_weight()
    _, other = _cache_and_weight(seed=1)
    cache(w)
    torch.testing.assert_close(cache(other), _permute_relayout(other), atol=0, rtol=0)
    assert cache.relayouts == 2
    del other
    import gc

    gc.collect()
    assert len(cache._cache) == 1


def test_ab_variants_patch_the_source():
    """Each design variant of ``tools/ab_resblock.py`` still finds what it
    patches in csrc/resblock.cu, once."""
    from ctrlv_tpu_torch.tools import ab_resblock

    src = (ab_resblock._build.CSRC / "resblock.cu").read_text()
    for name, patches in ab_resblock.VARIANTS.items():
        for old, _ in patches:
            assert src.count(old) == 1, (name, old)
