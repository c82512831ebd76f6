"""The port's attention kernels' modules against the JAX package's.

The JAX side runs its Pallas kernels as its own tests run them on the CPU,
in interpret mode; the port's wrappers take their plain versions for CPU
tensors. Inputs are seeded numpy arrays, f32.

Tolerance: both sides compute f32 logits, an f32 softmax and f32 products
on the CPU; they differ only in the order of sums, so 2e-5 absolute on
outputs of order 1 (the JAX package's own kernel-vs-XLA bound in
tests/test_fused_ops.py) holds for the ops, and 1e-4 for the modules,
whose outputs pass through several more f32 matmuls.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from ctrlv_tpu.models import layers as jax_layers
from ctrlv_tpu.ops import mha as jax_mha
from ctrlv_tpu.ops.geglu_ff import gelu_erf as jax_gelu_erf
from ctrlv_tpu_torch.convert import flax_to_state_dict
from ctrlv_tpu_torch.models import layers
from ctrlv_tpu_torch.ops import _launch, attention, geglu_ff, mha
from ctrlv_tpu_torch.tools import ab_mha

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _port_call(fn, arrays, heads, scale):
    return fn(*(torch.from_numpy(a) for a in arrays), heads, scale).numpy()


def test_mha_matches_jax_kernel():
    q, k, v = _qkv(0, (1, 1024, 128))
    scale = 64**-0.5
    assert jax_mha.mha_supported(1024, 1024, 128, 2, 4)
    assert mha.mha_supported(1024, 1024, 128, 2)
    ref = np.asarray(jax_mha.mha_attention(q, k, v, 2, scale))
    before = dict(mha.LAUNCHES)
    out = _port_call(mha.mha_attention, (q, k, v), 2, scale)
    np.testing.assert_allclose(out, ref, atol=2e-5)
    assert mha.LAUNCHES == before  # a CPU tensor takes the plain version, no launch


def test_small_mha_matches_jax_kernel():
    q, k, v = _qkv(1, (256, 25, 128))
    scale = 64**-0.5
    assert jax_mha.small_mha_supported(256, 25, 25, 128, 2, 4)
    assert mha.small_mha_supported(256, 25, 25, 128, 2)
    ref = np.asarray(jax_mha.small_mha_attention(q, k, v, 2, scale))
    out = _port_call(mha.small_mha_attention, (q, k, v), 2, scale)
    np.testing.assert_allclose(out, ref, atol=2e-5)


@pytest.mark.parametrize(
    "sq,sk,hd,heads,expect",
    [
        (2560, 2560, 320, 5, True),  # UNet/ControlNet level 0 spatial
        (640, 640, 640, 10, False),  # level 1 spatial: below S=1024
        (2560, 1, 320, 5, False),  # cross-attention to one token
        (1024, 1024, 128, 4, False),  # head dim 32
        (1100, 1100, 256, 2, True),  # ragged length: no block-size condition
    ],
)
def test_mha_gate(sq, sk, hd, heads, expect):
    assert mha.mha_supported(sq, sk, hd, heads) is expect


@pytest.mark.parametrize(
    "n,f,hd,heads,expect",
    [
        (5120, 25, 320, 5, True),  # the three temporal levels of the sampler
        (1280, 25, 640, 10, True),
        (320, 25, 1280, 20, True),
        (80, 25, 1280, 20, False),  # mid block: N below 256
        (5120, 65, 320, 5, False),  # more than 64 frames
        (5120, 25, 160, 5, False),  # head dim 32
    ],
)
def test_small_mha_gate(n, f, hd, heads, expect):
    assert mha.small_mha_supported(n, f, f, hd, heads) is expect


@pytest.mark.parametrize(
    "sq,sk,d,flash,expect",
    [
        (2560, 2560, 64, False, (192, 128, 4)),  # K1 at the 2560-token level
        (1000, 1000, 64, False, (192, 128, 4)),  # ragged last tile, 40 rows
        (160, 160, 64, False, (192, 128, 4)),  # K1's entry never takes 64 rows
        (1024, 2048, 128, False, (128, 128, 2)),  # head dim 128: two warpgroups, two stages
        (640, 640, 64, True, (128, 128, 4)),  # K8 at 640 tokens: five full tiles
        (160, 160, 64, True, (64, 64, 4)),  # K8 at 160 tokens: 1.25 tiles of 128
        (192, 192, 64, True, (64, 64, 4)),  # three full tiles of 64
        (200, 130, 128, True, (128, 128, 2)),  # the last tile 72 rows: more than half
        (37, 5, 64, True, (64, 64, 4)),
        (128, 128, 64, True, (128, 128, 4)),
    ],
)
def test_tile_plan(sq, sk, d, flash, expect):
    """The instantiation csrc/mha.cu takes, mirrored from its C tile_plan."""
    assert mha.tile_plan(sq, sk, d, flash) == expect


def test_tma_alignment_check_is_the_wrappers(monkeypatch):
    """TMA needs a 16-byte aligned base and rows a multiple of 16 bytes; the
    checks of both wrappers of csrc/mha.cu apply that test to every operand."""
    n = 2 * 64 * 128
    buf = torch.zeros(n + 8, dtype=torch.bfloat16)
    ok = buf[:n].view(2, 64, 128)
    bad = buf[4:n + 4].view(2, 64, 128)  # a contiguous view 8 bytes past the base
    assert ok.data_ptr() % 16 == 0 and bad.data_ptr() % 16 == 8
    _launch.check_tma_operands("t", 128, ok)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _launch.check_tma_operands("t", 128, ok, bad)
    with pytest.raises(ValueError, match="multiple of 16"):
        _launch.check_tma_operands("t", 12, ok)  # rows of 24 bytes
    # With the device checks out of the way, the wrappers' own checks raise.
    monkeypatch.setattr(mha, "check_operand", lambda *a, **k: None)
    monkeypatch.setattr(attention, "check_operand", lambda *a, **k: None)
    assert mha._check_cuda("mha", ok, ok, ok, 2, tma=True) == 64
    with pytest.raises(ValueError, match="16-byte aligned"):
        mha._check_cuda("mha", ok, bad, ok, 2, tma=True)
    as4 = lambda t: t.view(2, 64, 2, 64)  # noqa: E731
    assert attention._check_flash(as4(ok), as4(ok), as4(ok)) == (2, 64, 64, 2, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        attention._check_flash(as4(ok), as4(ok), as4(bad))


def test_ab_variants_patch_the_source():
    """Each design variant the A/B script builds is one exact edit of mha.cu."""
    src = (ab_mha._build.CSRC / "mha.cu").read_text()
    for name, patches in ab_mha.VARIANTS.items():
        for old, new in patches:
            assert src.count(old) == 1 and old != new, name


def test_plain_attention_switch_is_scoped():
    assert not mha.plain_selected()
    with pytest.raises(RuntimeError), mha.plain_kernels():
        assert mha.plain_selected()
        raise RuntimeError("leaves the block by an exception")
    assert not mha.plain_selected()


def test_wrapper_rejects_other_devices():
    q = torch.zeros(1, 1024, 128, device="meta")
    with pytest.raises(ValueError):
        mha.mha_attention(q, q, q, 2, 0.125)
    with pytest.raises(ValueError):
        mha.small_mha_attention(q, q, q, 2, 0.125)


def _load(module, params):
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}
    module.load_state_dict(flax_to_state_dict(flat), strict=True)
    return module.eval()


def _seeded(shapes, seed):
    rng = np.random.default_rng(seed)

    def fill(path, x):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(x.shape) / np.sqrt(x.shape[0])).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("shape", [(1, 1024, 128), (256, 25, 128)], ids=["spatial", "temporal"])
def test_attention_module_matches_jax(shape):
    """Attention at shapes that take the spatial and the temporal kernel."""
    jmod = jax_layers.Attention(query_dim=128, heads=2, dim_head=64)
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    params = _seeded(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x), 3)
    ref = np.asarray(jax.jit(jmod.apply)(params, x))
    port = _load(layers.Attention(128, heads=2, dim_head=64), params)
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_temporal_transformer_block_matches_jax():
    """The temporal block at a shape that takes the temporal kernel, with
    its single-token cross-attention."""
    jmod = jax_layers.TemporalBasicTransformerBlock(
        dim=128, num_attention_heads=2, attention_head_dim=64, cross_attention_dim=48
    )
    rng = np.random.default_rng(4)
    x = rng.standard_normal((256, 25, 128)).astype(np.float32)
    ctx = rng.standard_normal((256, 1, 48)).astype(np.float32)
    params = _seeded(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x, ctx), 5)
    ref = np.asarray(jax.jit(jmod.apply)(params, x, ctx))
    port = _load(layers.TemporalBasicTransformerBlock(128, 2, 64, cross_attention_dim=48), params)
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(ctx)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_gelu_routes_by_dtype():
    """bf16 takes the tanh form, f32 the erf form, as in the JAX package."""
    x = np.linspace(-6, 6, 4001).astype(np.float32)
    out32 = geglu_ff.gelu_erf(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out32, np.asarray(jax_gelu_erf(jnp.asarray(x))), atol=1e-6)
    xb = torch.from_numpy(x).bfloat16()
    tanh = torch.nn.functional.gelu(xb, approximate="tanh")
    assert torch.equal(geglu_ff.gelu_erf(xb), tanh)
    ref_b = np.asarray(jax_gelu_erf(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    # one bf16 ulp at the output's scale: the two frameworks round bf16 at other places
    np.testing.assert_allclose(geglu_ff.gelu_erf(xb).float().numpy(), ref_b, rtol=8e-3, atol=8e-3)


def test_import_leaves_jax_and_flax_out():
    """No module of the port imports JAX, flax, optax, orbax, the JAX package
    or the safetensors package."""
    code = (
        "import sys, ctrlv_tpu_torch, ctrlv_tpu_torch.models, ctrlv_tpu_torch.pipelines, "
        "ctrlv_tpu_torch.convert, ctrlv_tpu_torch.ops, ctrlv_tpu_torch.metrics.iou, "
        "ctrlv_tpu_torch.ops._launch, ctrlv_tpu_torch.ops._build, ctrlv_tpu_torch.ops.attention, "
        "ctrlv_tpu_torch.ops.group_norm, ctrlv_tpu_torch.ops.layer_norm, ctrlv_tpu_torch.ops.mha, "
        "ctrlv_tpu_torch.pipelines.common, ctrlv_tpu_torch.pipelines.overall, "
        "ctrlv_tpu_torch.pipelines.video_control, ctrlv_tpu_torch.pipelines.video_diffusion, "
        "ctrlv_tpu_torch.models.transformer_st, ctrlv_tpu_torch.diffusion, "
        "ctrlv_tpu_torch.ops.geglu_ff, ctrlv_tpu_torch.train, ctrlv_tpu_torch.train.loss, "
        "ctrlv_tpu_torch.train.state, ctrlv_tpu_torch.train.train_step, "
        "ctrlv_tpu_torch.ops.resblock, ctrlv_tpu_torch.train.lora, ctrlv_tpu_torch.train.ema, "
        "ctrlv_tpu_torch.tools.ab_mha, ctrlv_tpu_torch.utils.safetensors_io, "
        "ctrlv_tpu_torch.utils.config, ctrlv_tpu_torch.utils.video_io, "
        "ctrlv_tpu_torch.train.hf_import, ctrlv_tpu_torch.train.hf_export, "
        "ctrlv_tpu_torch.ops.rasterize, ctrlv_tpu_torch.data, ctrlv_tpu_torch.data.native, "
        "ctrlv_tpu_torch.data.collate, ctrlv_tpu_torch.data.base, ctrlv_tpu_torch.data.synthetic, "
        "ctrlv_tpu_torch.data.loader, ctrlv_tpu_torch.data.bdd100k, ctrlv_tpu_torch.data.kitti, "
        "ctrlv_tpu_torch.data.vkitti, ctrlv_tpu_torch.data.mkitti, "
        "ctrlv_tpu_torch.tools.common, ctrlv_tpu_torch.tools.eval_overall, "
        "ctrlv_tpu_torch.tools.eval_video_controlnet, ctrlv_tpu_torch.metrics.image, "
        "ctrlv_tpu_torch.train.checkpoints, ctrlv_tpu_torch.train.observability, "
        "ctrlv_tpu_torch.utils.misc, ctrlv_tpu_torch.utils.samples, "
        "ctrlv_tpu_torch.tools.train_video_controlnet, ctrlv_tpu_torch.tools.train_video_diffusion, "
        "ctrlv_tpu_torch.tools.train_vae_finetuning, ctrlv_tpu_torch.metrics, "
        "ctrlv_tpu_torch.metrics.fandj, ctrlv_tpu_torch.metrics.davis, ctrlv_tpu_torch.metrics.common, "
        "ctrlv_tpu_torch.metrics.lpips, ctrlv_tpu_torch.metrics.fvd, "
        "ctrlv_tpu_torch.metrics.offline_eval, ctrlv_tpu_torch.utils.resize, "
        "ctrlv_tpu_torch.tools.eval_video_bbox_prediction, "
        "ctrlv_tpu_torch.tools.eval_video_generation, ctrlv_tpu_torch.utils.profiling, "
        "ctrlv_tpu_torch.tools.flops, ctrlv_tpu_torch.tools.bench, "
        "ctrlv_tpu_torch.tools.bench_train, ctrlv_tpu_torch.tools.profile_denoise, "
        "ctrlv_tpu_torch.data.nuscenes_tables, ctrlv_tpu_torch.data.nuscenes, "
        "ctrlv_tpu_torch.data.davis, ctrlv_tpu_torch.utils.fourier, "
        "ctrlv_tpu_torch.tools.draw_teaser, ctrlv_tpu_torch.tools.run_tracking_metrics, "
        "ctrlv_tpu_torch.tools.preprocess_dataset, ctrlv_tpu_torch.tools.dataset_examples, "
        "ctrlv_tpu_torch.baseline, ctrlv_tpu_torch.baseline.config, "
        "ctrlv_tpu_torch.baseline.actions, ctrlv_tpu_torch.baseline.model, "
        "ctrlv_tpu_torch.baseline.policy, ctrlv_tpu_torch.baseline.image_encoder, "
        "ctrlv_tpu_torch.tools.train_bbox_baseline, ctrlv_tpu_torch.tools.eval_bbox_baseline, "
        "ctrlv_tpu_torch.models.unet_2d, ctrlv_tpu_torch.models.kitti_object_net, "
        "ctrlv_tpu_torch.models.layout_net, ctrlv_tpu_torch.models.bbox_attention, "
        "ctrlv_tpu_torch.models.unet_st, ctrlv_tpu_torch.utils.objectnet; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'ctrlv_tpu', 'safetensors')); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
