"""The port's frames-major temporal attention and BSHD one-pass attention
against the JAX package's, ops and modules.

The JAX side runs its Pallas kernels in interpret mode, as its own tests
run them on the CPU; the port's wrappers take their plain versions for CPU
tensors. Inputs are seeded numpy arrays, f32.

Tolerance: both sides compute f32 logits, an f32 softmax and f32 products
on the CPU and differ only in the order of sums: 2e-5 absolute on outputs
of order 1 for the ops (the JAX package's own kernel-vs-XLA bound in
tests/test_fused_ops.py), 1e-4 for the transformer, whose output passes
through a dozen more f32 matmuls.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctrlv_tpu.models.transformer_st import TransformerSpatioTemporalModel as JaxTransformer
from ctrlv_tpu.models.unet_st import UNetSpatioTemporalConditionModel as JaxUNet
from ctrlv_tpu.models.unet_st import UNetSTConfig as JaxUNetConfig
from ctrlv_tpu.ops import mha as jax_mha
from ctrlv_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from ctrlv_tpu_torch.convert import flax_to_state_dict
from ctrlv_tpu_torch.models import UNetSpatioTemporalConditionModel, UNetSTConfig, layers
from ctrlv_tpu_torch.models.controlnet import ControlNetSpatioTemporal
from ctrlv_tpu_torch.models.transformer_st import TransformerSpatioTemporalModel
from ctrlv_tpu_torch.ops import _launch, attention, mha
from test_torch_convert import flat, load, seeded_params

torch.set_num_threads(1)


def _qkv(seed, shape_q, shape_kv=None):
    rng = np.random.default_rng(seed)
    shapes = (shape_q, shape_kv or shape_q, shape_kv or shape_q)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def test_small_mha_fm_matches_jax_kernel():
    b, f, s, hd, heads = 1, 4, 256, 64, 1
    q, k, v = _qkv(0, (b * f, s, hd))
    scale = 64**-0.5
    assert jax_mha.small_mha_fm_supported(b * f, s, hd, heads, f, 4)
    assert mha.small_mha_fm_supported(b * f, s, hd, heads, f)
    ref = np.asarray(jax_mha.small_mha_attention_fm(q, k, v, heads, scale, f))
    before = dict(_launch.LAUNCHES)
    out = mha.small_mha_attention_fm(*map(torch.from_numpy, (q, k, v)), heads, scale, f).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5)
    assert _launch.LAUNCHES == before  # a CPU tensor takes the plain version, no launch


def test_small_mha_fm_is_the_seq_kernel_transposed():
    """Frames-major attention equals the (B*S, F, H*D) attention between a
    transpose pair, two heads and two batch elements."""
    b, f, s, hd, heads = 2, 5, 24, 128, 2
    q, k, v = map(torch.from_numpy, _qkv(1, (b * f, s, hd)))
    out = mha.small_mha_attention_fm(q, k, v, heads, 0.125, f)

    def to_seq(x):
        return x.reshape(b, f, s, hd).transpose(1, 2).reshape(b * s, f, hd)

    seq = mha.small_mha_attention(to_seq(q), to_seq(k), to_seq(v), heads, 0.125)
    back = seq.reshape(b, s, f, hd).transpose(1, 2).reshape(b * f, s, hd)
    torch.testing.assert_close(out, back, atol=1e-6, rtol=0)


@pytest.mark.parametrize("sq,sk", [(128, 128), (128, 256)], ids=["square", "sq_ne_sk"])
def test_flash_attention_matches_jax_kernel(sq, sk):
    q, k, v = _qkv(2, (2, sq, 1, 64), (2, sk, 1, 64))
    scale = 64**-0.5
    ref = np.asarray(jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale))
    before = dict(_launch.LAUNCHES)
    out = attention.flash_attention(*map(torch.from_numpy, (q, k, v)), scale).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5)
    assert _launch.LAUNCHES == before


@pytest.mark.parametrize(
    "bf,s,hd,heads,f,expect",
    [
        (50, 2560, 320, 5, 25, True),  # the three temporal levels of the sampler
        (50, 640, 640, 10, 25, True),
        (50, 160, 1280, 20, 25, True),
        (50, 40, 1280, 20, 25, False),  # mid block at CFG batch 2: 80 pixels, below 256
        (250, 40, 1280, 20, 25, True),  # mid block of stage 1's batch of ten
        (50, 2570, 320, 5, 25, True),  # no block size has to divide S
        (50, 2560, 320, 5, 24, False),  # B*F is no multiple of F
        (65, 2560, 320, 5, 65, False),  # more than 64 frames
        (50, 2560, 160, 5, 25, False),  # head dim 32
    ],
)
def test_small_mha_fm_gate(bf, s, hd, heads, f, expect):
    assert mha.small_mha_fm_supported(bf, s, hd, heads, f) is expect


@pytest.mark.parametrize(
    "sq,sk,d,dtype,expect",
    [
        (640, 640, 64, torch.bfloat16, True),  # the sampler's 640- and 160-token levels
        (160, 160, 64, torch.bfloat16, True),
        (128, 2560, 128, torch.bfloat16, True),  # Sq != Sk, head dim 128
        (40, 40, 64, torch.bfloat16, False),  # mid block: fewer than 128 tokens
        (2560, 1, 64, torch.bfloat16, False),  # cross-attention to one token
        (257, 257, 80, torch.bfloat16, False),  # CLIP's head dim
        (640, 640, 64, torch.float32, False),  # f32 activations
    ],
)
def test_flash_gate(sq, sk, d, dtype, expect):
    assert attention.flash_supported(sq, sk, d, dtype) is expect


def test_attention_impl_switch_routes_dot_product_attention(monkeypatch):
    """"xla" keeps the plain version, "pallas" and "auto" take the kernel's
    wrapper where the gate passes, plain_kernels() overrides both."""
    calls = []
    real = attention.flash_attention
    monkeypatch.setattr(attention, "flash_attention",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    q = torch.randn(1, 128, 2, 64, dtype=torch.bfloat16)
    small = torch.randn(1, 64, 2, 64, dtype=torch.bfloat16)
    assert attention.get_attention_impl() == "auto"
    try:
        for impl, expect in (("xla", 0), ("pallas", 1), ("auto", 1)):
            attention.set_attention_impl(impl)
            calls.clear()
            out = attention.dot_product_attention(q, q, q)
            attention.dot_product_attention(small, small, small)  # below the gate
            attention.dot_product_attention(q.float(), q.float(), q.float())  # f32
            with _launch.plain_kernels():
                attention.dot_product_attention(q, q, q)
            assert len(calls) == expect, impl
            assert torch.equal(out, attention.flash_attention_plain(q, q, q, 0.125))
        with pytest.raises(ValueError):
            attention.set_attention_impl("cudnn")
    finally:
        attention.set_attention_impl("auto")


def test_flash_wrapper_rejects_other_devices():
    q = torch.zeros(1, 128, 1, 64, device="meta")
    with pytest.raises(ValueError):
        attention.flash_attention(q, q, q, 0.125)
    with pytest.raises(ValueError):
        mha.small_mha_attention_fm(q.reshape(1, 128, 64), q.reshape(1, 128, 64),
                                   q.reshape(1, 128, 64), 1, 0.125, 1)


TRANSFORMER_KW = dict(num_attention_heads=1, attention_head_dim=64, in_channels=64,
                      cross_attention_dim=48)


@pytest.fixture(scope="module")
def transformer_case():
    """A JAX spatio-temporal transformer at head dim 64 with 256 pixels, so
    that its frames-major attention takes the JAX kernel, and its inputs."""
    b, f, hgt, wdt, c = 1, 4, 16, 16, 64
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b * f, hgt, wdt, c)).astype(np.float32)
    ehs = rng.standard_normal((b * f, 1, 48)).astype(np.float32)
    ioi = np.zeros((b, f), np.float32)
    jmod = JaxTransformer(temporal_layout="frames_major", **TRANSFORMER_KW)
    params = seeded_params(jmod, 6, x, ehs, ioi)
    assert jax_mha.small_mha_fm_supported(b * f, hgt * wdt, 64, 1, f, 4)
    ref = np.asarray(jax.jit(jmod.apply)(params, x, ehs, ioi))
    return params, (x, ehs, ioi), ref


@pytest.mark.parametrize("layout", ["frames_major", "seq"])
def test_transformer_st_matches_jax_frames_major(transformer_case, layout):
    """Both layouts of the port's transformer, from the same converted
    weights, against the JAX one in its frames-major layout."""
    params, (x, ehs, ioi), ref = transformer_case
    port = load(TransformerSpatioTemporalModel(1, 64, 64, cross_attention_dim=48,
                                               temporal_layout=layout), params)
    with torch.no_grad():
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(), torch.from_numpy(ehs),
                   torch.from_numpy(ioi))
    assert out.is_contiguous()
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, atol=1e-4, rtol=1e-4)


def test_temporal_block_frames_major_matches_seq_layout():
    """TemporalBasicTransformerBlock(frames_major=F) on (B*F, S, C) equals
    the (B*S, F, C) call between a transpose pair, with the same weights."""
    b, f, s, c = 2, 5, 8, 64
    torch.manual_seed(0)
    blk = layers.TemporalBasicTransformerBlock(c, 2, 32, cross_attention_dim=48).eval()
    x_fm = torch.randn(b * f, s, c)
    ctx = torch.randn(b, 1, 1, 48)
    with torch.no_grad():
        out_fm = blk(x_fm, ctx.expand(b, f, 1, 48).reshape(b * f, 1, 48), frames_major=f)
        x_seq = x_fm.reshape(b, f, s, c).transpose(1, 2).reshape(b * s, f, c)
        out_seq = blk(x_seq, ctx.expand(b, s, 1, 48).reshape(b * s, 1, 48))
    back = out_seq.reshape(b, s, f, c).transpose(1, 2).reshape(b * f, s, c)
    torch.testing.assert_close(out_fm, back, atol=2e-5, rtol=0)
    with pytest.raises(ValueError):
        blk.attn1(x_fm, context=x_fm, temporal_frames=f)


@pytest.mark.parametrize("layout", ["seq", "frames_major"])
def test_converted_unet_loads_strict_in_both_layouts(layout):
    """The layout is a constructor keyword, not a weight: one converted JAX
    UNet state dict loads with strict=True into either, and into the
    ControlNet's shared part; the models hand the keyword to every
    transformer."""
    cfg = JaxUNetConfig.micro(num_frames=3)
    junet = JaxUNet(config=cfg)
    sample = jnp.zeros((1, 3, 8, 8, 8))
    params = seeded_params(junet, 7, sample, jnp.asarray(0.5), jnp.zeros((1, 1, 48)),
                           jnp.zeros((1, 3)))
    unet = UNetSpatioTemporalConditionModel(UNetSTConfig.micro(), temporal_layout=layout)
    unet.load_state_dict(flax_to_state_dict(flat(params)), strict=True)
    ctrl = ControlNetSpatioTemporal(UNetSTConfig.micro(), temporal_layout=layout)
    for net in (unet, ctrl):
        found = [m.temporal_layout for m in net.modules()
                 if isinstance(m, TransformerSpatioTemporalModel)]
        assert found and set(found) == {layout}
    with pytest.raises(ValueError):
        UNetSpatioTemporalConditionModel(UNetSTConfig.micro(), temporal_layout="pixels_major")
