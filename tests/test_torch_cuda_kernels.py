"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc (sm_90a) and skip without one.
On the card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: tests/conftest.py configures JAX, which a GPU host of
the port need not have; this file imports only torch and the port.)

Tolerance: bf16 operands from a seeded generator, outputs of order 1. The
attention kernels round P to bf16 before the product with V at other places
than the plain versions, and the outputs are bf16 (ulp 2^-8 relative), so
they agree to a few bf16 ulps: |kernel - plain| <= 1e-2 * (1 + |plain|).
The norm kernels sum in another order and round once, one bf16 ulp apart at
most, inside the same bound. The feed-forward kernel accumulates its two
products in another order than cuBLAS and rounds a, g, their product and y to
bf16, inside the same bound too; so does the fused ResBlock, whose plain
version repeats its roundings (h once, y once) and whose two runs on the same
input must agree to the bit.

Gradients: a wrapper's backward differentiates its plain version, so the
gradient through the wrapper is held against the gradient through the plain
version alone: the same arithmetic on the same inputs, equal to a few bf16
ulps of reduction order.
"""

import pytest
import torch

from ctrlv_tpu_torch.models import layers
from ctrlv_tpu_torch.models.resnet import ResnetBlock2D
from ctrlv_tpu_torch.models.transformer_st import TransformerSpatioTemporalModel
from ctrlv_tpu_torch.ops import (
    _launch, attention, geglu_ff, group_norm, layer_norm, mha, resblock,
)

pytestmark = pytest.mark.cuda

TOL = 1e-2


def assert_close(out, ref):
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL, atol=TOL)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _qkv(shape_q, shape_kv, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = lambda s: torch.randn(s, generator=gen, device=device, dtype=torch.bfloat16)  # noqa: E731
    return draw(shape_q), draw(shape_kv), draw(shape_kv)


@pytest.mark.parametrize(
    "b,sq,sk,hd,heads",
    [
        (2, 1024, 1024, 128, 2),  # head dim 64
        (2, 1100, 1100, 256, 2),  # ragged query and key tiles, head dim 128
        (2, 1024, 2048, 192, 3),  # more keys than queries
        (2, 2560, 2560, 320, 5),  # the sampler's heads at one batch element
        (3, 1000, 1000, 320, 5),  # a ragged tile must not read the next element's rows
    ],
)
def test_mha_kernel_matches_plain(cuda, b, sq, sk, hd, heads):
    q, k, v = _qkv((b, sq, hd), (b, sk, hd), cuda)
    scale = (hd // heads) ** -0.5
    before = mha.LAUNCHES["mha"]
    out = mha.mha_attention(q, k, v, heads, scale)
    torch.cuda.synchronize()
    assert mha.LAUNCHES["mha"] == before + 1
    ref = mha.mha_attention_plain(q, k, v, heads, scale)
    assert_close(out, ref)


@pytest.mark.parametrize("f", [2, 16, 25, 32, 33, 64])
@pytest.mark.parametrize("hd,heads", [(320, 5), (256, 2)])
def test_small_mha_kernel_matches_plain(cuda, f, hd, heads):
    q, k, v = _qkv((301, f, hd), (301, f, hd), cuda, seed=f)
    scale = (hd // heads) ** -0.5
    before = mha.LAUNCHES["small_mha"]
    out = mha.small_mha_attention(q, k, v, heads, scale)
    torch.cuda.synchronize()
    assert mha.LAUNCHES["small_mha"] == before + 1
    ref = mha.small_mha_attention_plain(q, k, v, heads, scale)
    assert_close(out, ref)


def test_wrappers_raise_instead_of_falling_back(cuda):
    q = torch.zeros(1, 1024, 128, device=cuda)
    with pytest.raises(TypeError):  # f32: the kernels take bf16
        mha.mha_attention(q, q, q, 2, 0.125)
    qb = torch.zeros(1, 1024, 256, device=cuda, dtype=torch.bfloat16)[..., :128]
    with pytest.raises(ValueError):  # not contiguous
        mha.mha_attention(qb, qb, qb, 2, 0.125)
    qs = torch.zeros(300, 25, 96, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # head dim 48
        mha.small_mha_attention(qs, qs, qs, 2, 0.125)
    # TMA needs a 16-byte aligned base: a contiguous view 8 bytes past one
    buf = torch.zeros(1024 * 128 + 8, device=cuda, dtype=torch.bfloat16)
    qa = buf[4:4 + 1024 * 128].view(1, 1024, 128)
    assert qa.is_contiguous() and qa.data_ptr() % 16 == 8
    with pytest.raises(ValueError):
        mha.mha_attention(qa, qa, qa, 2, 0.125)
    with pytest.raises(ValueError):
        attention.flash_attention(qa.view(1, 1024, 2, 64), qa.view(1, 1024, 2, 64),
                                  qa.view(1, 1024, 2, 64), 0.125)


def test_attention_module_routes_to_kernels(cuda):
    """Attention in bf16 on the card launches the kernel at the kernel's
    shapes, and agrees with the same module under plain_kernels()."""
    torch.manual_seed(0)
    attn = layers.Attention(320, heads=5, dim_head=64).to(cuda, torch.bfloat16)
    for x_shape, name in (((2, 1024, 320), "mha"), ((512, 25, 320), "small_mha")):
        x = torch.randn(x_shape, device=cuda, dtype=torch.bfloat16)
        before = dict(mha.LAUNCHES)
        with torch.no_grad():
            out = attn(x)
            with mha.plain_kernels():
                ref = attn(x)
        torch.cuda.synchronize()
        assert mha.LAUNCHES[name] == before[name] + 1
        assert_close(out, ref)


@pytest.mark.parametrize("f", [2, 14, 25, 40])
@pytest.mark.parametrize("hd,heads", [(320, 5), (256, 2)], ids=["d64", "d128"])
def test_small_mha_fm_kernel_matches_plain(cuda, f, hd, heads):
    b, s = 2, 151  # an odd pixel count: no block size has to divide it
    q, k, v = _qkv((b * f, s, hd), (b * f, s, hd), cuda, seed=f)
    scale = (hd // heads) ** -0.5
    before = mha.LAUNCHES["small_mha_fm"]
    out = mha.small_mha_attention_fm(q, k, v, heads, scale, f)
    torch.cuda.synchronize()
    assert mha.LAUNCHES["small_mha_fm"] == before + 1
    assert_close(out, mha.small_mha_attention_fm_plain(q, k, v, heads, scale, f))
    # the same numbers as the seq-layout kernel between a transpose pair
    to_seq = lambda x: x.reshape(b, f, s, hd).transpose(1, 2).reshape(b * s, f, hd)  # noqa: E731
    seq = mha.small_mha_attention(to_seq(q), to_seq(k), to_seq(v), heads, scale)
    assert torch.equal(out, seq.reshape(b, s, f, hd).transpose(1, 2).reshape(b * f, s, hd))


@pytest.mark.parametrize(
    "sq,sk,heads,d",
    [
        (128, 128, 2, 64),
        (160, 160, 20, 64),  # 1.25 tiles of 128: the 64-row instantiation
        (640, 640, 10, 64),
        (160, 640, 3, 64),  # Sq != Sk
        (200, 130, 2, 128),  # ragged both ways, head dim 128
        (192, 192, 10, 64),  # three full tiles of 64: the 64-row instantiation
    ],
)
def test_flash_kernel_matches_plain(cuda, sq, sk, heads, d):
    q, k, v = _qkv((3, sq, heads, d), (3, sk, heads, d), cuda, seed=sq)
    before = _launch.LAUNCHES["flash"]
    out = attention.flash_attention(q, k, v, d**-0.5)
    torch.cuda.synchronize()
    assert _launch.LAUNCHES["flash"] == before + 1
    assert_close(out, attention.flash_attention_plain(q, k, v, d**-0.5))


def _affine(c, device, dtype, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    w = 1.0 + 0.2 * torch.randn(c, generator=gen, device=device)
    b = 0.2 * torch.randn(c, generator=gen, device=device)
    return w.to(dtype), b.to(dtype)


@pytest.mark.parametrize("cpg", [10, 20, 40, 80])
@pytest.mark.parametrize("spatial", [(5, 8), (10, 16), (40, 64), (25, 10, 16)],
                         ids=["L40", "L160", "L2560", "5d"])
@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_kernel_matches_plain(cuda, cpg, spatial, act):
    c = 32 * cpg
    gen = torch.Generator(device=cuda).manual_seed(cpg)
    x = (1.5 * torch.randn((3, c) + spatial, generator=gen, device=cuda) + 0.3).bfloat16()
    w, b = _affine(c, cuda, torch.bfloat16)
    before = _launch.LAUNCHES["group_norm"]
    out = group_norm.group_norm(x, w, b, 32, 1e-5, act)
    torch.cuda.synchronize()
    assert _launch.LAUNCHES["group_norm"] == before + 1
    assert_close(out, group_norm.group_norm_plain(x, w, b, 32, 1e-5, act))


@pytest.mark.parametrize(
    "shape,groups",
    [
        ((2, 33, 7, 9), 3),  # run of 693 elements: the scalar path, in shared memory
        ((2, 6, 251, 163), 2),  # run of 122 739: the scalar path, split over blocks
        ((1, 128, 320, 512), 32),  # a VAE decoder shape: 655 360 a run, 40 slices
        ((4, 512, 2560), 32),  # (B, C, S): the VAE attention's norm
        ((1, 128, 3, 320, 512), 32),  # 1 966 080 a run: the cap of 64 slices, 30 720 each
        ((1, 2, 1_100_003), 2),  # capped, scalar, slices rounded up to a multiple of 8
    ],
)
def test_group_norm_kernel_ragged_and_long_runs(cuda, shape, groups):
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(shape, generator=gen, device=cuda).bfloat16()
    w, b = _affine(shape[1], cuda, torch.float32)  # f32 parameters
    out = group_norm.group_norm(x, w, b, groups, 1e-6, "silu")
    torch.cuda.synchronize()
    assert_close(out, group_norm.group_norm_plain(x, w, b, groups, 1e-6, "silu"))


@pytest.mark.parametrize("path", ["short", "cluster", "two_pass"])
@pytest.mark.parametrize(
    "shape,groups",
    [
        ((3, 320, 40, 64), 32),  # short runs of 25 600 elements
        ((5, 2560, 5, 8), 32),  # runs of 3 200, several an item
        ((1, 320, 25, 40, 64), 32),  # a temporal ResBlock's runs of 640 000
        ((2, 64, 24, 8), 2),  # 32 channels a group
    ],
    ids=str,
)
def test_group_norm_forced_paths_match_plain_and_repeat(cuda, shape, groups, path):
    """Each path of K4's plan, forced where it can take the shape: one launch,
    the plain version's values, and the same bits twice."""
    plan = group_norm.plan_for(path, shape, groups)
    if plan is None:
        assert path == "short" and group_norm._dims(shape, groups)[1] > 100_000
        return
    gen = torch.Generator(device=cuda).manual_seed(len(shape) + groups)
    x = (1.5 * torch.randn(shape, generator=gen, device=cuda) + 0.3).bfloat16()
    w, b = _affine(shape[1], cuda, torch.bfloat16)
    before = _launch.LAUNCHES["group_norm"]
    out = group_norm._group_norm_cuda(x, w, b, groups, 1e-5, "silu", plan)
    again = group_norm._group_norm_cuda(x, w, b, groups, 1e-5, "silu", plan)
    torch.cuda.synchronize()
    assert _launch.LAUNCHES["group_norm"] == before + 2
    assert torch.equal(out, again)
    assert_close(out, group_norm.group_norm_plain(x, w, b, groups, 1e-5, "silu"))


def _bf16_ulps(a, b):
    """The largest distance between two bf16 tensors in bf16 ulps."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return int((ordered(a) - ordered(b)).abs().max())


@pytest.mark.parametrize("path", ["short", "cluster", "two_pass"])
@pytest.mark.parametrize("shape", [(2, 2560, 5, 8), (1, 2560, 25, 16, 16)], ids=str)
def test_group_norm_silu_within_one_bf16_ulp(cuda, shape, path):
    """K4's SiLU at normalised values y in [-10, 0], where 1 + exp(-y) is
    large: gamma 0 and beta spread over the channels make y = beta exactly in
    the kernel and in the plain version, so the two may differ by the SiLU's
    rounding alone, one bf16 ulp at most."""
    plan = group_norm.plan_for(path, shape, 32)
    if plan is None:
        assert path == "short" and group_norm._dims(shape, 32)[1] > 100_000
        return
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(shape, generator=gen, device=cuda).bfloat16()
    w = torch.zeros(shape[1], device=cuda)
    b = torch.linspace(-10.0, 0.0, shape[1], device=cuda)
    out = group_norm._group_norm_cuda(x, w, b, 32, 1e-5, "silu", plan)
    ref = group_norm.group_norm_plain(x, w, b, 32, 1e-5, "silu")
    assert _bf16_ulps(out, ref) <= 1


@pytest.mark.parametrize("c", [8, 72, 200, 320, 640, 1280, 1288, 2048])  # 1 to 32 lanes a row
@pytest.mark.parametrize("rows", [1, 257, 3003])
def test_layer_norm_lane_splits_repeat(cuda, c, rows):
    """K5 at every split of a row over lanes: the plain version's values, the
    same bits twice."""
    gen = torch.Generator(device=cuda).manual_seed(c + rows)
    x = (2.0 * torch.randn((rows, c), generator=gen, device=cuda) - 0.5).bfloat16()
    w, b = _affine(c, cuda, torch.bfloat16)
    out, again = layer_norm.layer_norm(x, w, b, 1e-5), layer_norm.layer_norm(x, w, b, 1e-5)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert_close(out, layer_norm.layer_norm_plain(x, w, b, 1e-5))


@pytest.mark.parametrize("c", [320, 640, 1280, 2048, 8])
@pytest.mark.parametrize("rows", [(257,), (3, 1001)])
@pytest.mark.parametrize("pdtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_layer_norm_kernel_matches_plain(cuda, c, rows, pdtype):
    gen = torch.Generator(device=cuda).manual_seed(c)
    x = (2.0 * torch.randn(rows + (c,), generator=gen, device=cuda) - 0.5).bfloat16()
    w, b = _affine(c, cuda, pdtype)
    before = _launch.LAUNCHES["layer_norm"]
    out = layer_norm.layer_norm(x, w, b, 1e-5)
    torch.cuda.synchronize()
    assert _launch.LAUNCHES["layer_norm"] == before + 1
    assert out.shape == x.shape
    assert_close(out, layer_norm.layer_norm_plain(x, w, b, 1e-5))


def test_new_wrappers_raise_instead_of_falling_back(cuda):
    f32 = torch.zeros(4, 128, 2, 64, device=cuda)
    with pytest.raises(TypeError):  # f32: the kernel takes bf16
        attention.flash_attention(f32, f32, f32, 0.125)
    with pytest.raises(TypeError):
        mha.small_mha_attention_fm(f32.reshape(4, 128, 128), f32.reshape(4, 128, 128),
                                   f32.reshape(4, 128, 128), 2, 0.125, 2)
    x = torch.zeros(2, 64, 8, 16, device=cuda, dtype=torch.bfloat16)
    w, b = _affine(64, cuda, torch.bfloat16)
    with pytest.raises(ValueError):  # not contiguous (a channels-last view)
        group_norm.group_norm(x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2), w, b, 32)
    flat = torch.zeros(2 * 64 * 8 * 16 + 1, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # starts 2 bytes off a 16-byte boundary
        group_norm.group_norm(flat[1:].reshape(2, 64, 8, 16), w, b, 32)
    rows = torch.zeros(16, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        layer_norm.layer_norm(rows[:, :64], w, b)
    with pytest.raises(ValueError):
        layer_norm.layer_norm(torch.zeros(16 * 64 + 1, device=cuda,
                                          dtype=torch.bfloat16)[1:].reshape(16, 64), w, b)
    # outside the gates the plain versions serve, by the gate and not by an exception
    before = dict(_launch.LAUNCHES)
    group_norm.group_norm(x.float(), w.float(), b.float(), 32)
    layer_norm.layer_norm(rows.float()[:, :64].contiguous(), w.float(), b.float())
    attention.dot_product_attention(f32, f32, f32)
    assert _launch.LAUNCHES == before


def test_norm_modules_and_switches_route_to_kernels(cuda):
    torch.manual_seed(0)
    gn = layers.GroupNorm(32, 320, 1e-5, act="silu").to(cuda, torch.bfloat16)
    ln = layers.LayerNorm(320).to(cuda, torch.bfloat16)
    x = torch.randn(4, 320, 10, 16, device=cuda, dtype=torch.bfloat16)
    rows = torch.randn(4, 160, 320, device=cuda, dtype=torch.bfloat16)
    _launch.reset_launch_counts()
    with torch.no_grad():
        out_gn, out_ln = gn(x), ln(rows)
        assert (_launch.LAUNCHES["group_norm"], _launch.LAUNCHES["layer_norm"]) == (1, 1)
        with _launch.plain_kernels():
            ref_gn, ref_ln = gn(x), ln(rows)
        try:
            group_norm.set_fused_group_norm(False)
            layer_norm.set_fused_layer_norm(False)
            off_gn, off_ln = gn(x), ln(rows)
        finally:
            group_norm.set_fused_group_norm(True)
            layer_norm.set_fused_layer_norm(True)
    torch.cuda.synchronize()
    assert (_launch.LAUNCHES["group_norm"], _launch.LAUNCHES["layer_norm"]) == (1, 1)
    assert torch.equal(off_gn, ref_gn) and torch.equal(off_ln, ref_ln)
    assert_close(out_gn, ref_gn)
    assert_close(out_ln, ref_ln)


def test_attention_modules_route_to_new_kernels(cuda):
    """The 640-token self-attention takes the one-pass kernel under "auto"
    and "pallas" and the library's attention (SDPA) under "xla"; the frames-major
    transformer takes the frames-major kernel, the seq one the seq kernel,
    and both agree with the all-plain run."""
    torch.manual_seed(0)
    attn = layers.Attention(640, heads=10, dim_head=64).to(cuda, torch.bfloat16)
    x = torch.randn(2, 640, 640, device=cuda, dtype=torch.bfloat16)
    with torch.no_grad():
        try:
            for impl, launches in (("auto", 1), ("pallas", 1), ("xla", 0)):
                attention.set_attention_impl(impl)
                _launch.reset_launch_counts()
                out = attn(x)
                assert _launch.LAUNCHES["flash"] == launches, impl
        finally:
            attention.set_attention_impl("auto")
        with _launch.plain_kernels():
            ref = attn(x)
        assert_close(attn(x), ref)

        model = TransformerSpatioTemporalModel(5, 64, 320, cross_attention_dim=48).to(
            cuda, torch.bfloat16)
        h = torch.randn(2 * 5, 320, 16, 16, device=cuda, dtype=torch.bfloat16)
        ctx = torch.randn(2 * 5, 1, 48, device=cuda, dtype=torch.bfloat16)
        ioi = torch.zeros(2, 5, device=cuda, dtype=torch.bfloat16)
        with _launch.plain_kernels():
            ref = model(h, ctx, ioi)
        for layout, name in (("seq", "small_mha"), ("frames_major", "small_mha_fm")):
            model.temporal_layout = layout
            _launch.reset_launch_counts()
            out = model(h, ctx, ioi)
            assert _launch.LAUNCHES[name] == 1, layout
            assert out.is_contiguous()
            assert_close(out, ref)
    torch.cuda.synchronize()


def _ff_operands(m, c, device, seed=0, ln=False):
    gen = torch.Generator(device=device).manual_seed(seed)
    inner = 4 * c

    def draw(shape, scale):
        return (scale * torch.randn(shape, generator=gen, device=device)).bfloat16()

    ops = [draw((m, c), 1.0), draw((2 * inner, c), c**-0.5), draw((2 * inner,), 0.1),
           draw((c, inner), inner**-0.5), draw((c,), 0.1)]
    if ln:
        w, b = _affine(c, device, torch.bfloat16, seed)
        ops = [1.5 * ops[0] + 0.3, w, b] + ops[1:]
    return ops


# A block holds 128 rows at C = 320 and 64 at C = 640: one row, whole tiles, and
# a last tile of one row or of part of a tile.
@pytest.mark.parametrize("ln", [False, True], ids=["ff", "ff_ln"])
@pytest.mark.parametrize("m,c", [(64, 320), (4096, 320), (1001, 320), (1, 320), (128, 320),
                                 (129, 320), (256, 320), (257, 320), (32, 640), (4096, 640),
                                 (999, 640), (64, 640), (128, 640), (129, 640)])
def test_geglu_ff_kernel_matches_plain(cuda, m, c, ln):
    ops = _ff_operands(m, c, cuda, seed=m, ln=ln)
    fn, plain = ((geglu_ff.geglu_ff_ln, geglu_ff.geglu_ff_ln_plain) if ln
                 else (geglu_ff.geglu_ff, geglu_ff.geglu_ff_plain))
    before = _launch.LAUNCHES["geglu_ff"]
    out = fn(*ops)
    torch.cuda.synchronize()
    assert _launch.LAUNCHES["geglu_ff"] == before + 1
    assert out.shape == (m, c) and out.dtype == torch.bfloat16
    assert_close(out, plain(*ops))
    assert torch.equal(out, fn(*ops))  # no float atomics: the same bits twice


def test_geglu_ff_raises_instead_of_falling_back(cuda):
    x, w1, b1, w2, b2 = _ff_operands(64, 320, cuda)
    with pytest.raises(TypeError):  # f32 rows: the kernel takes bf16
        geglu_ff.geglu_ff(x.float(), w1, b1, w2, b2)
    with pytest.raises(ValueError):  # not contiguous
        geglu_ff.geglu_ff(x.t().contiguous().t(), w1, b1, w2, b2)
    wide = _ff_operands(64, 1280, cuda)
    with pytest.raises(ValueError):  # the gate refuses C = 1280: forcing it raises
        geglu_ff.geglu_ff(*wide)
    with pytest.raises(ValueError):  # w2 of another inner width
        geglu_ff.geglu_ff(x, w1, b1, w2[:, :640].contiguous(), b2)


def test_feed_forward_module_routes_to_the_kernel(cuda):
    torch.manual_seed(0)
    ff = layers.FeedForward(320).to(cuda, torch.bfloat16)
    wide = layers.FeedForward(1280).to(cuda, torch.bfloat16)
    x = torch.randn(2, 300, 320, device=cuda, dtype=torch.bfloat16)
    default = geglu_ff._ENABLED
    with torch.no_grad():
        try:
            geglu_ff.set_fused_geglu_ff(False)
            off = ff(x)
            geglu_ff.set_fused_geglu_ff(True)
            _launch.reset_launch_counts()
            out = ff(x)
            wide(torch.randn(2, 8, 1280, device=cuda, dtype=torch.bfloat16))  # by the gate
            assert _launch.LAUNCHES["geglu_ff"] == 1
            with _launch.plain_kernels():
                plain = ff(x)
            assert _launch.LAUNCHES["geglu_ff"] == 1
        finally:
            geglu_ff.set_fused_geglu_ff(default)
    torch.cuda.synchronize()
    assert out.shape == x.shape
    assert_close(out, plain)
    assert_close(out, off)  # the unfused path: tanh gelu, at most a bf16 ulp of act away


def _resblock_operands(n, c, h, w, device, seed=0, pdtype=torch.bfloat16):
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(shape, scale=1.0, shift=0.0, dtype=torch.bfloat16):
        return (shift + scale * torch.randn(shape, generator=gen, device=device)).to(dtype)

    weight = lambda: draw((c, c, 3, 3), (9 * c) ** -0.5)  # noqa: E731
    vec = lambda scale, shift=0.0: draw((c,), scale, shift, pdtype)  # noqa: E731
    return [draw((n, c, h, w), 1.5, 0.3), vec(0.2, 1.0), vec(0.1), weight(), vec(0.1),
            draw((n, c)), vec(0.2, 1.0), vec(0.1), weight(), vec(0.1)]


@pytest.mark.parametrize("pdtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("n,c,h,w", [(2, 320, 40, 64), (3, 320, 11, 16), (2, 640, 20, 32),
                                     (2, 1280, 10, 16), (2, 1280, 5, 8), (1, 320, 1, 128),
                                     (2, 320, 3, 8), (7, 1280, 5, 8), (5, 1280, 10, 16),
                                     (9, 320, 40, 64), (17, 1280, 1, 8)])
def test_resblock_kernel_matches_plain(cuda, n, c, h, w, pdtype):
    """Whole tiles, a ragged last tile of image rows, every width the gate
    admits; tiles that span several samples (5x8: 3.2 a tile, 10x16: 0.8, one-row
    images: 16), 320 output channels a block (9 x 40 x 64); norm parameters and
    biases in bf16 or f32, temb in the other."""
    if (n, h) in ((7, 5), (5, 10), (17, 1)):
        assert resblock._plan(n, c, h, w, 32, torch.bfloat16).max_seg >= 2
    if (n, h) == (9, 40):
        assert resblock._plan(n, c, h, w, 32, torch.bfloat16).halves == 2
    ops = _resblock_operands(n, c, h, w, cuda, seed=h, pdtype=pdtype)
    if pdtype == torch.bfloat16:
        ops[5] = ops[5].float()  # temb in f32, as the JAX function takes it
    before = _launch.LAUNCHES["resblock"]
    out = resblock.fused_resblock2d(*ops, 32, 1e-5)
    again = resblock.fused_resblock2d(*ops, 32, 1e-5)
    torch.cuda.synchronize()
    assert _launch.LAUNCHES["resblock"] == before + 2
    assert out.shape == (n, c, h, w) and out.dtype == torch.bfloat16
    assert torch.equal(out, again)  # no atomics: the same bits every time
    assert_close(out, resblock.fused_resblock2d_plain(*ops, 32, 1e-5))


def test_resblock_kernel_follows_a_weight_changed_in_place(cuda):
    """The re-laid weights are cached: a frozen weight is re-laid once; an
    update in place under no_grad makes a fresh copy, and the next output is
    the plain version's with the new weight."""
    ops = _resblock_operands(3, 640, 10, 16, cuda, seed=4)
    before = resblock.relaid_weights.relayouts
    first = resblock.fused_resblock2d(*ops, 32, 1e-5)
    again = resblock.fused_resblock2d(*ops, 32, 1e-5)
    assert resblock.relaid_weights.relayouts == before + 2  # w1 and w2, once each
    assert torch.equal(first, again)
    with torch.no_grad():
        ops[8].add_(0.5 * ops[8].flip(0))
    out = resblock.fused_resblock2d(*ops, 32, 1e-5)
    torch.cuda.synchronize()
    assert resblock.relaid_weights.relayouts == before + 3
    assert not torch.equal(out, first)
    assert_close(out, resblock.fused_resblock2d_plain(*ops, 32, 1e-5))


def test_resblock_kernel_zero_pads_the_border(cuda):
    """Impulses at the corners and the centre, as tests/test_resblock.py has them."""
    ops = _resblock_operands(1, 320, 8, 16, cuda)
    x = torch.zeros_like(ops[0])
    for i, j in [(0, 0), (0, 15), (7, 0), (7, 15), (4, 8)]:
        x[0, :, i, j] = 1.0
    ops[0] = x
    assert_close(resblock.fused_resblock2d(*ops, 32, 1e-5),
                 resblock.fused_resblock2d_plain(*ops, 32, 1e-5))


def test_resblock_raises_instead_of_falling_back(cuda):
    ops = _resblock_operands(2, 320, 8, 16, cuda)
    with pytest.raises(TypeError):  # f32 activations: the kernel takes bf16
        resblock.fused_resblock2d(ops[0].float(), *ops[1:])
    with pytest.raises(ValueError):  # channels-last memory: not contiguous
        resblock.fused_resblock2d(ops[0].to(memory_format=torch.channels_last), *ops[1:])
    with pytest.raises(ValueError):  # the gate refuses W = 24: forcing it raises
        resblock.fused_resblock2d(*_resblock_operands(2, 320, 8, 24, cuda))
    with pytest.raises(ValueError):  # a weight of another width
        resblock.fused_resblock2d(*ops[:3], ops[3][:160].contiguous(), *ops[4:])


def test_resnet_block_routes_to_the_kernel(cuda):
    torch.manual_seed(0)
    block = ResnetBlock2D(320, 320, 1280, eps=1e-5).to(cuda, torch.bfloat16)
    skip = ResnetBlock2D(640, 320, 1280, eps=1e-5).to(cuda, torch.bfloat16)
    x = torch.randn(2, 320, 16, 32, device=cuda, dtype=torch.bfloat16)
    temb = torch.randn(2, 1280, device=cuda, dtype=torch.bfloat16)
    with torch.no_grad():
        off = block(x, temb)
        try:
            resblock.set_fused_resblock(True)
            _launch.reset_launch_counts()
            out = block(x, temb)
            skip(torch.cat([x, x], dim=1), temb)  # a 1x1 shortcut: the unfused path
            assert _launch.LAUNCHES["resblock"] == 1
            norms = _launch.LAUNCHES["group_norm"]
            with _launch.plain_kernels():
                plain = block(x, temb)
            assert (_launch.LAUNCHES["resblock"], _launch.LAUNCHES["group_norm"]) == (1, norms)
        finally:
            resblock.set_fused_resblock(False)
    torch.cuda.synchronize()
    assert norms == 2  # the skip block's two; the routed block launched no K4
    assert_close(out, plain)
    assert_close(out, off)  # the unfused module rounds h twice: a bf16 ulp of h away


def _grad_case(kind, device):
    """(wrapper, plain, operands) at a small shape the kernel takes."""
    gen = torch.Generator(device=device).manual_seed(11)
    draw = lambda *s: torch.randn(s, generator=gen, device=device, dtype=torch.bfloat16)  # noqa: E731
    if kind == "mha":
        return (lambda *t: mha.mha_attention(*t, 2, 0.125),
                lambda *t: mha.mha_attention_plain(*t, 2, 0.125),
                [draw(2, 1100, 128) for _ in range(3)])
    if kind == "small_mha":
        return (lambda *t: mha.small_mha_attention(*t, 5, 0.125),
                lambda *t: mha.small_mha_attention_plain(*t, 5, 0.125),
                [draw(301, 25, 320) for _ in range(3)])
    if kind == "small_mha_fm":
        return (lambda *t: mha.small_mha_attention_fm(*t, 5, 0.125, 25),
                lambda *t: mha.small_mha_attention_fm_plain(*t, 5, 0.125, 25),
                [draw(50, 151, 320) for _ in range(3)])
    if kind == "flash":
        return (lambda *t: attention.flash_attention(*t, 0.125),
                lambda *t: attention.flash_attention_plain(*t, 0.125),
                [draw(3, 160, 10, 64) for _ in range(3)])
    if kind == "group_norm":
        w, b = _affine(320, device, torch.bfloat16)
        return (lambda *t: group_norm.group_norm(*t, 32, 1e-5, "silu"),
                lambda *t: group_norm.group_norm_plain(*t, 32, 1e-5, "silu"),
                [1.5 * draw(3, 320, 10, 16) + 0.3, w, b])
    if kind == "layer_norm":
        w, b = _affine(320, device, torch.bfloat16)
        return (lambda *t: layer_norm.layer_norm(*t, 1e-5),
                lambda *t: layer_norm.layer_norm_plain(*t, 1e-5), [draw(257, 320), w, b])
    if kind == "resblock":
        return (lambda *t: resblock.fused_resblock2d(*t, 32, 1e-5),
                lambda *t: resblock.fused_resblock2d_plain(*t, 32, 1e-5),
                _resblock_operands(3, 320, 11, 16, device))
    if kind == "geglu_ff":
        return geglu_ff.geglu_ff, geglu_ff.geglu_ff_unfused, _ff_operands(1001, 320, device)
    return (geglu_ff.geglu_ff_ln, geglu_ff.geglu_ff_ln_unfused,
            _ff_operands(1001, 640, device, ln=True))


@pytest.mark.parametrize("kind", ["mha", "small_mha", "small_mha_fm", "flash", "group_norm",
                                  "layer_norm", "geglu_ff", "geglu_ff_ln", "resblock"])
def test_wrapper_gradient_matches_plain_gradient(cuda, kind):
    """A CUDA operand that requires a gradient gets the kernel's forward and
    the gradient of the plain version; one that does not gets None."""
    fn, plain, ops = _grad_case(kind, cuda)
    name = "geglu_ff" if kind.startswith("geglu") else kind
    ins = [t.clone().requires_grad_(True) for t in ops]
    before = _launch.LAUNCHES[name]
    out = fn(*ins)
    assert _launch.LAUNCHES[name] == before + 1 and out.requires_grad
    with torch.no_grad():
        assert torch.equal(out, fn(*ops))  # the same forward as without a gradient
    r = torch.randn(out.shape, device=cuda, dtype=torch.bfloat16)
    grads = torch.autograd.grad((out * r).sum(), ins)
    ref_ins = [t.clone().requires_grad_(True) for t in ops]
    ref = torch.autograd.grad((plain(*ref_ins) * r).sum(), ref_ins)
    torch.cuda.synchronize()
    for g, g_ref in zip(grads, ref):
        assert g.shape == g_ref.shape and torch.isfinite(g).all()
        err = (g.float() - g_ref.float()).norm() / g_ref.float().norm().clamp_min(1e-12)
        assert err.item() <= 1e-2, (kind, err.item())
    # only the first operand asks: the others get no gradient and cost no backward work
    first = ops[0].clone().requires_grad_(True)
    out = fn(first, *ops[1:])
    out.backward(r)
    assert first.grad is not None and all(t.grad is None for t in ops[1:])


def test_bf16_checkpoint_loads_straight_onto_the_card(cuda, tmp_path):
    """A bf16 component written from the card reads back onto the card, by
    file and into a module, equal to the source bit for bit."""
    from ctrlv_tpu_torch.models import CLIPVisionConfig, CLIPVisionModelWithProjection
    from ctrlv_tpu_torch.train.hf_export import save_pipeline
    from ctrlv_tpu_torch.train.hf_import import load_hf_component, load_safetensors

    torch.manual_seed(0)
    src = CLIPVisionModelWithProjection(CLIPVisionConfig.tiny()).to(cuda, torch.bfloat16)
    save_pipeline(str(tmp_path), image_encoder=src)
    ref = src.state_dict()
    got = load_safetensors(str(tmp_path / "image_encoder" / "model.safetensors"), device=cuda)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert got[k].device.type == "cuda" and got[k].dtype == torch.bfloat16, k
        assert torch.equal(got[k], v), k
    dst = CLIPVisionModelWithProjection(CLIPVisionConfig.tiny()).to(cuda, torch.bfloat16)
    assert load_hf_component(str(tmp_path / "image_encoder"), dst) == []
    for k, v in dst.state_dict().items():
        assert torch.equal(v, ref[k]), k
