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
most, inside the same bound.
"""

import pytest
import torch

from ctrlv_tpu_torch.models import layers
from ctrlv_tpu_torch.models.transformer_st import TransformerSpatioTemporalModel
from ctrlv_tpu_torch.ops import _launch, attention, group_norm, layer_norm, mha

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
    "sq,sk,hd,heads",
    [
        (1024, 1024, 128, 2),  # head dim 64
        (1100, 1100, 256, 2),  # ragged query and key tiles, head dim 128
        (1024, 2048, 192, 3),  # more keys than queries
        (2560, 2560, 320, 5),  # the sampler's heads at one batch element
    ],
)
def test_mha_kernel_matches_plain(cuda, sq, sk, hd, heads):
    q, k, v = _qkv((2, sq, hd), (2, sk, hd), cuda)
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
        (160, 160, 20, 64),  # 2.5 tiles of 64: the 32-row instantiation
        (640, 640, 10, 64),
        (160, 640, 3, 64),  # Sq != Sk
        (200, 130, 2, 128),  # ragged both ways, head dim 128
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
    and "pallas" and the plain version under "xla"; the frames-major
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
