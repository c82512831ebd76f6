"""The port's legacy models against the JAX package's, at tiny configs.

Each JAX module gets seeded parameters (``seeded_params``: every leaf random,
shapes from ``jax.eval_shape``), converted by ``convert.py`` and loaded with
``load_state_dict(strict=True)``; the same seeded inputs go through one
jitted JAX apply and the port's forward, in f32 on the CPU.

- ``UNet2DConditionModel`` with both object hooks, ``Transformer2D`` and
  ``TextTimeEmbedding``: 1e-4 relative L2; the object tokens must matter.
- ``KittiObjectNet`` on the collate's (B, N) and clip (B, F, N) forms.
- ``LayoutNet``, its loss and its causality; ``generate_step``; the
  ``convert_objects`` / ``revert_embed`` round trip.
- ``BBOXFrameAttention`` at init (exactly the channel repeat) and with
  ``rz_weight = 1``; the bbox-cond UNet-ST's ``encode_bbox_frame``, which the
  encoded objects do not move (ROADMAP §3).
- The baseline's ``ImageEncoder`` over the tiny VAE and CLIP.
- A strict load of every new module's converted state dict.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctrlv_tpu.baseline import BaselineConfig as JaxBaselineConfig
from ctrlv_tpu.baseline import BboxPredictorLM as JaxLM
from ctrlv_tpu.baseline import ImageContextProjector as JaxProjector
from ctrlv_tpu.baseline import ImageEncoder as JaxImageEncoder
from ctrlv_tpu.models import bbox_attention as jax_bbox_attention
from ctrlv_tpu.models import kitti_object_net as jax_kon
from ctrlv_tpu.models import layout_net as jax_layout
from ctrlv_tpu.models import unet_2d as jax_unet_2d
from ctrlv_tpu.models import unet_st as jax_unet_st
from ctrlv_tpu.utils import objectnet as jax_objectnet
from ctrlv_tpu_torch.baseline import BaselineConfig, BboxPredictorLM, ImageEncoder
from ctrlv_tpu_torch.baseline.image_encoder import ImageContextProjector
from ctrlv_tpu_torch.convert import flax_to_state_dict
from ctrlv_tpu_torch.data.collate import objects_to_arrays
from ctrlv_tpu_torch.models import (
    AutoencoderKLTemporalDecoder,
    BBOXFrameAttention,
    CLIPVisionConfig,
    CLIPVisionModelWithProjection,
    KittiObjectNet,
    LayoutNet,
    LayoutNetConfig,
    UNet2DConditionModel,
    UNet2DConfig,
    UNetSpatioTemporalConditionModelWithBBoxCond,
    UNetSTConfig,
    VAEConfig,
)
from ctrlv_tpu_torch.models.unet_2d import TextTimeEmbedding, Transformer2D
from ctrlv_tpu_torch.utils import objectnet
from helpers import build_tiny_models
from test_torch_convert import flat, seeded_params

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _load(module, params):
    module.load_state_dict(flax_to_state_dict(flat(params)), strict=True)
    return module.eval()


def _nchw(x):
    return _t(np.asarray(x).transpose(0, 3, 1, 2))


def _objects(rng, frames=3, n=30, live=5):
    """A collated batch's padded objects (the port's collate), clip form."""
    labels = []
    for _ in range(frames):
        labels.append([dict(
            truncated=rng.random(), occluded=int(rng.integers(0, 4)), alpha=rng.uniform(-3, 3),
            bbox=rng.uniform(0, 200, 4), dimensions=rng.uniform(1, 3, 3),
            location=rng.uniform(-5, 30, 3), rotation_y=rng.uniform(-3, 3),
            id_type=int(rng.integers(0, 9)), trackID=int(rng.integers(1, 40)),
        ) for _ in range(live)])
    arrays = objects_to_arrays(labels)
    return {k: v[None] for k, v in arrays.items() if k != "num_objects"}


# --- UNet2D and its pieces ---------------------------------------------------

UNET_CFG = dict(addition_embed_type="object", encoder_hid_dim_type="text_object_proj")


@pytest.fixture(scope="module")
def unet2d():
    jcfg = jax_unet_2d.UNet2DConfig.tiny(**UNET_CFG)
    jmodel = jax_unet_2d.UNet2DConditionModel(config=jcfg)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    text = rng.standard_normal((2, 7, jcfg.cross_attention_dim)).astype(np.float32)
    objs = rng.standard_normal((2, 4, jcfg.object_dim)).astype(np.float32)
    params = seeded_params(jmodel, 20, x, jnp.asarray(10.0), text, objs)
    port = _load(UNet2DConditionModel(UNet2DConfig.tiny(**UNET_CFG)), params)
    return jmodel, params, port, (x, np.float32(10.0), text, objs)


def test_unet2d_with_object_hooks_matches_jax(unet2d):
    jmodel, params, port, (x, ts, text, objs) = unet2d
    apply = jax.jit(jmodel.apply)
    want = apply(params, x, ts, text, objs)
    want2 = apply(params, x, ts, text, objs + 1.0)
    with torch.no_grad():
        got = port(_t(x), _t(ts), _t(text), _t(objs))
        got2 = port(_t(x), _t(ts), _t(text), _t(objs + 1.0))
    assert got.shape == want.shape == (2, 8, 8, 4)
    assert _rel_l2(got, want) < 1e-4 and _rel_l2(got2, want2) < 1e-4
    # the object tokens matter, and through both hooks
    assert _rel_l2(got2, got) > 1e-3
    with torch.no_grad():
        port.object_u.zero_()
        only_w = port(_t(x), _t(ts), _t(text), _t(objs + 1.0))
        port.object_u.fill_(1.0)
        port.object_w.zero_()
        only_u = port(_t(x), _t(ts), _t(text), _t(objs + 1.0))
        port.object_w.fill_(1.0)
    assert _rel_l2(only_w, got2) > 1e-4 and _rel_l2(only_u, got2) > 1e-4


def test_transformer2d_matches_jax():
    jmod = jax_unet_2d.Transformer2D(in_channels=64, num_heads=2, cross_attention_dim=24)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 5, 64)).astype(np.float32)
    ctx = rng.standard_normal((2, 3, 24)).astype(np.float32)
    params = seeded_params(jmod, 21, x, ctx)
    port = _load(Transformer2D(64, 2, cross_attention_dim=24), params)
    want = jax.jit(jmod.apply)(params, x, ctx)
    with torch.no_grad():
        got = port(_nchw(x), _t(ctx)).permute(0, 2, 3, 1)
    assert _rel_l2(got, want) < 1e-4


def test_text_time_embedding_matches_jax():
    jmod = jax_unet_2d.TextTimeEmbedding(time_embed_dim=48)
    tokens = np.random.default_rng(2).standard_normal((2, 5, 32)).astype(np.float32)
    params = seeded_params(jmod, 22, tokens)
    port = _load(TextTimeEmbedding(32, 48), params)
    want = jax.jit(jmod.apply)(params, tokens)
    with torch.no_grad():
        got = port(_t(tokens))
    assert got.shape == (2, 48) and _rel_l2(got, want) < 1e-4


# --- object and layout models ----------------------------------------------------

def test_kitti_object_net_matches_jax():
    jmod = jax_kon.KittiObjectNet(out_dim=24, mid_dim=32)
    objs = _objects(np.random.default_rng(3))
    frame = {k: v[:, 0] for k, v in objs.items()}
    params = seeded_params(jmod, 23, {k: jnp.asarray(v) for k, v in frame.items()})
    port = _load(KittiObjectNet(out_dim=24, mid_dim=32), params)
    apply = jax.jit(jmod.apply)
    for inputs, shape in ((frame, (1, 30, 24)), (objs, (1, 3, 30, 24))):
        want = apply(params, {k: jnp.asarray(v) for k, v in inputs.items()})
        with torch.no_grad():
            got = port({k: torch.from_numpy(v) for k, v in inputs.items()})
        assert got.shape == want.shape == shape
        assert _rel_l2(got, want) < 1e-5


@pytest.fixture(scope="module")
def layout_net():
    cfg = jax_layout.LayoutNetConfig.tiny()
    jmod = jax_layout.LayoutNet(config=cfg)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, cfg.n_layout + cfg.n_cond)).astype(np.float32)
    labels = rng.standard_normal((2, 6, cfg.n_layout)).astype(np.float32)
    params = seeded_params(jmod, 24, x, labels)
    return jmod, params, _load(LayoutNet(LayoutNetConfig.tiny()), params), x, labels


def test_layout_net_matches_jax_and_is_causal(layout_net):
    jmod, params, port, x, labels = layout_net
    want, want_loss = jax.jit(jmod.apply)(params, x, labels)
    with torch.no_grad():
        got, loss = port(_t(x), _t(labels))
        x2 = _t(x)
        x2[:, -1] += 10.0
        got2, _ = port(x2)
    assert _rel_l2(got, want) < 1e-5
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    # an earlier prediction does not change when a later input does
    torch.testing.assert_close(got2[:, :-1], got[:, :-1], atol=1e-5, rtol=0)
    assert not torch.allclose(got2[:, -1], got[:, -1])


def test_generate_step_matches_jax(layout_net):
    jmod, params, port, x, _ = layout_net
    cfg = LayoutNetConfig.tiny()
    seed = x[:, :3, :cfg.n_layout]
    cond = x[:, 0, cfg.n_layout:]
    jitted = types.SimpleNamespace(apply=jax.jit(jmod.apply))
    want = jax_objectnet.generate_step(jitted, params, jnp.asarray(seed), jnp.asarray(cond), 3)
    got = objectnet.generate_step(port, _t(seed), _t(cond), 3)
    assert got.shape == want.shape == (2, 6, cfg.n_layout)
    assert _rel_l2(got, want) < 1e-5


def test_convert_objects_round_trip():
    objs = _objects(np.random.default_rng(5))
    want = jax_objectnet.convert_objects({k: jnp.asarray(v) for k, v in objs.items()})
    got = objectnet.convert_objects({k: torch.from_numpy(v) for k, v in objs.items()})
    assert got.shape == (1, 3, 30 * objectnet.OBJECT_DIM) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = objectnet.revert_embed(got, 30)
    jback = jax_objectnet.revert_embed(want, 30)
    assert back.keys() == jback.keys()
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jback[k]), err_msg=k)
        np.testing.assert_array_equal(v.numpy(), objs[k].astype(v.numpy().dtype), err_msg=k)


# --- bbox-frame attention and the bbox-cond UNet-ST --------------------------------

def test_bbox_frame_attention_matches_jax():
    f = 3
    jmod = jax_bbox_attention.BBOXFrameAttention(num_frames=f, in_channels=4, out_channels=4 * f,
                                                 num_layers=1, norm_num_groups=4)
    x = np.random.default_rng(6).standard_normal((2, 6, 8, 4)).astype(np.float32)
    params = seeded_params(jmod, 25, x)
    flat_params = flat(params)
    for rz in (0.0, 1.0):
        flat_params["params/rz_weight"] = np.full((1,), rz, np.float32)
        port = BBOXFrameAttention(f, 4, 4 * f, num_layers=1)
        port.load_state_dict(flax_to_state_dict(flat_params), strict=True)
        with torch.no_grad():
            got = port(_nchw(x))
        if rz == 0.0:  # exactly the channel block repeated, as jnp.tile on NHWC
            assert torch.equal(got, _nchw(x).repeat(1, f, 1, 1))
            continue
        from flax import traverse_util

        tree = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                             for k, v in flat_params.items()})
        want = jax.jit(jmod.apply)(tree, x)
        assert _rel_l2(got.permute(0, 2, 3, 1), want) < 1e-4
        assert _rel_l2(got, _nchw(x).repeat(1, f, 1, 1)) > 1e-3


def test_encode_bbox_frame_matches_jax_and_ignores_objects():
    f = 3
    jcfg = jax_unet_st.UNetSTConfig.tiny(num_frames=f)
    jmod = jax_unet_st.UNetSpatioTemporalConditionModelWithBBoxCond(config=jcfg,
                                                                    num_bbox_attn_layers=1)
    rng = np.random.default_rng(7)
    latent = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    objects = rng.standard_normal((1, f, 5, 16)).astype(np.float32)
    shapes = jax.eval_shape(lambda k: jmod.init(k, latent, objects, method=jmod.encode_bbox_frame),
                            jax.random.PRNGKey(0))
    params = seeded_params_like(shapes, 26)
    params["params"]["bbox_frame_attention"]["rz_weight"] = jnp.ones((1,))
    port = UNetSpatioTemporalConditionModelWithBBoxCond(UNetSTConfig.tiny(), num_frames=f,
                                                        num_bbox_attn_layers=1)
    port.bbox_frame_attention.load_state_dict(flax_to_state_dict(
        flat(params["params"]["bbox_frame_attention"])), strict=True)
    port.eval()
    want = jax.jit(lambda p, a, o: jmod.apply(p, a, o, method=jmod.encode_bbox_frame))(
        params, latent, objects)
    with torch.no_grad():
        got = port.encode_bbox_frame(_nchw(latent), _t(objects))
        moved = port.encode_bbox_frame(_nchw(latent), _t(objects + 5.0))
        none = port.encode_bbox_frame(_nchw(latent), None)
    assert got.shape == (1, f, 4, 8, 8)
    assert _rel_l2(got.permute(0, 1, 3, 4, 2), want) < 1e-4
    assert torch.equal(got, moved) and torch.equal(got, none)


def seeded_params_like(shapes, seed):
    """``seeded_params``' leaves for an already traced param tree."""
    rng = np.random.default_rng(seed)

    def fill(path, x):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(x.shape) / np.sqrt(np.prod(x.shape[:-1]))).astype(
                np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


# --- the baseline's image encoder ---------------------------------------------------

def test_image_encoder_matches_jax():
    m = build_tiny_models(num_frames=3, image_hw=(32, 32), components=())
    size = m["clip_cfg"].image_size
    vae_params = seeded_params(m["vae"], 27, jnp.zeros((1, 32, 32, 3)))
    clip_params = seeded_params(m["clip"], 28, jnp.zeros((1, size, size, 3)))
    jcfg = JaxBaselineConfig.tiny(map_embedding=True)
    jenc = JaxImageEncoder(jcfg, m["vae"], vae_params, m["clip"], clip_params)
    images = np.random.default_rng(8).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    clip_e, vae_l = jax.eval_shape(jenc.features, jnp.asarray(images))
    proj_params = seeded_params(jenc.projector, 29, jnp.zeros(clip_e.shape),
                                jnp.zeros(vae_l.shape))
    want = jax.jit(jenc.__call__)(proj_params, jnp.asarray(images))

    vae = _load(AutoencoderKLTemporalDecoder(VAEConfig.tiny()), vae_params)
    clip = CLIPVisionModelWithProjection(CLIPVisionConfig.tiny())
    clip.load_state_dict(flax_to_state_dict(flat(clip_params), "image_encoder"), strict=True)
    enc = ImageEncoder(BaselineConfig.tiny(map_embedding=True), vae, clip.eval())
    _load(enc.projector, proj_params)
    with torch.no_grad():
        got = enc(_t(images))
    assert got.shape == want.shape == (2, 33, 32)
    assert _rel_l2(got, want) < 1e-4


# --- strict loads ---------------------------------------------------------------------

def _shapes(module, *args):
    return seeded_params_like(jax.eval_shape(lambda k: module.init(k, *args),
                                             jax.random.PRNGKey(0)), 0)


STRICT = {
    "unet2d": lambda: (
        _shapes(jax_unet_2d.UNet2DConditionModel(jax_unet_2d.UNet2DConfig.tiny(**UNET_CFG)),
                jnp.zeros((1, 8, 8, 4)), jnp.asarray(1.0), jnp.zeros((1, 7, 32)),
                jnp.zeros((1, 4, 32))),
        UNet2DConditionModel(UNet2DConfig.tiny(**UNET_CFG))),
    "kitti_object_net": lambda: (
        _shapes(jax_kon.KittiObjectNet(out_dim=24, mid_dim=32),
                {k: jnp.asarray(v[:, 0]) for k, v in _objects(np.random.default_rng(0)).items()}),
        KittiObjectNet(out_dim=24, mid_dim=32)),
    "layout_net": lambda: (
        _shapes(jax_layout.LayoutNet(jax_layout.LayoutNetConfig.tiny()), jnp.zeros((1, 4, 24))),
        LayoutNet(LayoutNetConfig.tiny())),
    "bbox_frame_attention": lambda: (
        _shapes(jax_bbox_attention.BBOXFrameAttention(num_frames=3, out_channels=12),
                jnp.zeros((1, 4, 4, 4))),
        BBOXFrameAttention(3, 4, 12)),
    "bbox_lm": lambda: (
        _shapes(JaxLM(cfg=JaxBaselineConfig.tiny(existence_head=True)), {
            "bboxes": jnp.zeros((1, 5, 4, 4)), "type_ids": jnp.zeros((1, 5, 4, 1)),
            "existence": jnp.ones((1, 5, 4, 1), bool), "actions": jnp.zeros((1, 5, 4, 2, 2))}),
        BboxPredictorLM(BaselineConfig.tiny(existence_head=True))),
    "image_context_projector": lambda: (
        _shapes(JaxProjector(JaxBaselineConfig.tiny()), jnp.zeros((1, 48)),
                jnp.zeros((1, 20, 24, 4))),
        ImageContextProjector(BaselineConfig.tiny(), 48)),
}


@pytest.mark.parametrize("name", sorted(STRICT))
def test_strict_load(name):
    params, module = STRICT[name]()
    state = flax_to_state_dict(flat(params))
    module.load_state_dict(state, strict=True)
    own = module.state_dict()
    assert all(own[k].shape == v.shape for k, v in state.items())


def test_unet2d_at_sd1x_width_has_the_jax_parameters():
    """The SD1.x-width UNet2D with both hooks (built on the meta device): the
    converted names and shapes of the JAX module's parameters, one for one,
    about 0.86 B of them."""
    jmod = jax_unet_2d.UNet2DConditionModel(jax_unet_2d.UNet2DConfig(**UNET_CFG))
    shapes = jax.eval_shape(lambda k: jmod.init(
        k, jnp.zeros((1, 64, 64, 4)), jnp.asarray(1.0), jnp.zeros((1, 77, 768)),
        jnp.zeros((1, 16, 768))), jax.random.PRNGKey(0))
    from flax import traverse_util

    perm = {1: (0,), 2: (1, 0), 4: (3, 2, 0, 1)}
    want = {}
    for path, x in traverse_util.flatten_dict(shapes, sep="/").items():
        name = next(iter(flax_to_state_dict({path: np.zeros((1,) * len(x.shape))})))
        shape = tuple(x.shape)
        want[name] = tuple(shape[i] for i in perm[len(shape)]) if path.endswith(
            "/kernel") else shape
    with torch.device("meta"):
        port = UNet2DConditionModel(UNet2DConfig(**UNET_CFG))
    own = {k: tuple(p.shape) for k, p in port.named_parameters()}
    assert own == want
    total = sum(int(np.prod(s)) for s in own.values())
    assert 0.85e9 < total < 0.88e9, total
