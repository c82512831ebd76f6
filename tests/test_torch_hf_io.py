"""The port's checkpoints: the safetensors format without the package, and
diffusers directories across the two packages.

(a) The port's writer against the ``safetensors`` package's reader and the
    other way round, for F32, F16, BF16 and I64, and shards merged in
    sorted order: equal bit for bit.
(b) The JAX package's ``save_pipeline`` of seeded tiny params into the
    port's ``build_models`` (strict): the loaded tensors equal the port's
    converter's (``convert.flax_to_state_dict``) bit for bit, and the VAE's
    encode and decode, CLIP and a micro UNet loaded this way match the JAX
    forwards at the tolerance of tests/test_torch_convert.py (f32 on the
    CPU, atol = rtol = 1e-4). The port's ``save_pipeline`` into the JAX
    package's ``load_hf_component`` gives back the JAX params bit for bit.
    An extra key is dropped; a missing key or a wrong shape raises.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctrlv_tpu.models import (
    AutoencoderKLTemporalDecoder as JaxVAE,
    CLIPVisionConfig as JaxCLIPConfig,
    CLIPVisionModelWithProjection as JaxCLIP,
    UNetSpatioTemporalConditionModel as JaxUNet,
    UNetSTConfig as JaxUNetConfig,
    VAEConfig as JaxVAEConfig,
)
from ctrlv_tpu.train import hf_export as jax_hf_export
from ctrlv_tpu.train import hf_import as jax_hf_import
from ctrlv_tpu_torch.convert import flax_to_state_dict
from ctrlv_tpu_torch.models import UNetSpatioTemporalConditionModel, UNetSTConfig
from ctrlv_tpu_torch.tools.common import build_models
from ctrlv_tpu_torch.train.hf_export import save_pipeline
from ctrlv_tpu_torch.train.hf_import import load_hf_component, load_safetensors
from ctrlv_tpu_torch.utils import safetensors_io
from ctrlv_tpu_torch.utils.config import Config
from test_torch_convert import flat, seeded_params

torch.set_num_threads(1)

ATOL = RTOL = 1e-4
F, H, W = 2, 16, 16


def _tensors(seed=0):
    rng = np.random.default_rng(seed)
    f32 = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
    return {
        "a.f32": f32,
        "b.f16": torch.from_numpy(rng.standard_normal((4, 2, 3)).astype(np.float16)),
        "c.bf16": f32.to(torch.bfloat16) * 3,
        "d.i64": torch.from_numpy(rng.integers(-2**40, 2**40, (7,))),
        "e.scalar": torch.tensor(2.5),
        "f.empty": torch.zeros((0, 3), dtype=torch.bfloat16),
    }


def _assert_same(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        assert torch.equal(got[k], ref[k]), k


def test_port_writes_what_safetensors_reads(tmp_path):
    from safetensors import safe_open

    ref = _tensors()
    path = str(tmp_path / "port.safetensors")
    safetensors_io.save_file(ref, path, metadata={"format": "pt", "origin": "port"})
    with safe_open(path, framework="pt") as f:
        got = {k: f.get_tensor(k) for k in f.keys()}
        assert f.metadata() == {"format": "pt", "origin": "port"}
    _assert_same(got, ref)
    _assert_same(safetensors_io.load_file(path), ref)
    with open(path, "rb") as f:  # the header is padded to 8 bytes
        assert (8 + int.from_bytes(f.read(8), "little")) % 8 == 0


def test_port_reads_what_safetensors_writes(tmp_path):
    from safetensors.torch import save_file

    ref = _tensors(1)
    path = str(tmp_path / "package.safetensors")
    save_file(ref, path, metadata={"format": "pt"})
    _assert_same(load_safetensors(path), ref)


def test_reader_rejects_a_bad_header(tmp_path):
    path = str(tmp_path / "bad.safetensors")
    safetensors_io.save_file({"x": torch.ones(4)}, path)
    data = bytearray(open(path, "rb").read())
    data[-4:] = b""  # the file ends before the tensor's bytes do
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="offsets"):
        safetensors_io.load_file(path)


def test_shards_merge_in_sorted_order(tmp_path):
    net = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    sd = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(i))
          for i, (k, v) in enumerate(net.state_dict().items())}
    comp = tmp_path / "unet"
    comp.mkdir()
    # the second shard sorts last, so its copy of 1.bias wins over the first's
    safetensors_io.save_file({k: sd[k] for k in ("0.weight", "0.bias", "1.bias")},
                             str(comp / "model-00001-of-00002.safetensors"))
    safetensors_io.save_file({"1.weight": sd["1.weight"], "1.bias": sd["1.bias"] + 1},
                             str(comp / "model-00002-of-00002.safetensors"))
    assert load_hf_component(str(comp), net) == []
    got = net.state_dict()
    for k in ("0.weight", "0.bias", "1.weight"):
        assert torch.equal(got[k], sd[k]), k
    assert torch.equal(got["1.bias"], sd["1.bias"] + 1)


@pytest.fixture(scope="module")
def jax_tiny():
    """Seeded tiny JAX params. The VAE's and CLIP's trees take their shapes
    from flax and their leaves from numpy (``seeded_params``); the tiny
    UNet's tree is what the JAX importer makes of seeded numpy tensors under
    the port's names (tracing its init costs seconds; the micro UNet below
    takes its tree from flax and is held against the JAX forward)."""
    rng = np.random.default_rng(30)
    unet_sd = {k: (0.1 * rng.standard_normal(tuple(v.shape))).astype(np.float32)
               for k, v in UNetSpatioTemporalConditionModel(UNetSTConfig.tiny()).state_dict().items()}
    size = JaxCLIPConfig.tiny().image_size
    vae, clip = JaxVAE(config=JaxVAEConfig.tiny()), JaxCLIP(config=JaxCLIPConfig.tiny())
    params = dict(
        unet={"params": jax_hf_import.torch_state_dict_to_flax(unet_sd)},
        vae=seeded_params(vae, 31, jnp.zeros((1, H, W, 3))),
        clip=seeded_params(clip, 32, jnp.zeros((1, size, size, 3))),
    )
    return dict(params=params, vae=vae, clip=clip)


@pytest.fixture(scope="module")
def checkpoint(jax_tiny, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_pipeline"))
    p = jax_tiny["params"]
    jax_hf_export.save_pipeline(out, unet_params=p["unet"], vae_params=p["vae"],
                                clip_params=p["clip"])
    return out


@pytest.fixture(scope="module")
def port_models(checkpoint):
    cfg = Config(pretrained_model_name_or_path=checkpoint, mixed_precision="no", device="cpu")
    return build_models(cfg, tiny=True, with_controlnet=True)


def test_build_models_loads_the_jax_checkpoint(jax_tiny, port_models):
    for key, comp in (("unet", None), ("vae", None), ("clip", "image_encoder")):
        ref = flax_to_state_dict(flat(jax_tiny["params"][key]), comp)
        _assert_same(port_models[key].state_dict(), ref)
    # the ControlNet starts from the loaded UNet's shared weights
    unet_sd, ctrl_sd = port_models["unet"].state_dict(), port_models["ctrl"].state_dict()
    assert torch.equal(ctrl_sd["down_blocks.0.resnets.0.spatial_res_block.conv1.weight"],
                       unet_sd["down_blocks.0.resnets.0.spatial_res_block.conv1.weight"])


def test_vae_and_clip_match_jax_forwards(jax_tiny, port_models):
    p = jax_tiny["params"]
    rng = np.random.default_rng(5)
    img = rng.uniform(-1, 1, (2, H, W, 3)).astype(np.float32)
    vae = jax_tiny["vae"]
    ref_lat = np.asarray(jax.jit(lambda x: vae.apply(p["vae"], x, method=vae.encode))(img))
    lat = port_models["vae"].encode(torch.from_numpy(img))
    np.testing.assert_allclose(lat.detach().numpy(), ref_lat, atol=ATOL, rtol=RTOL)

    z = rng.standard_normal(ref_lat.shape).astype(np.float32)
    ref_dec = np.asarray(jax.jit(
        lambda z: vae.apply(p["vae"], z, num_frames=2, method=vae.decode))(z))
    dec = port_models["vae"].decode(torch.from_numpy(z), 2)
    np.testing.assert_allclose(dec.detach().numpy(), ref_dec, atol=ATOL, rtol=RTOL)

    clip = jax_tiny["clip"]
    size = JaxCLIPConfig.tiny().image_size
    pix = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    ref_emb = np.asarray(jax.jit(lambda x: clip.apply(p["clip"], x))(pix))
    emb = port_models["clip"](torch.from_numpy(pix))
    np.testing.assert_allclose(emb.detach().numpy(), ref_emb, atol=ATOL, rtol=RTOL)


def test_micro_unet_from_a_jax_checkpoint_matches(tmp_path):
    ucfg = JaxUNetConfig.micro(num_frames=F)
    junet = JaxUNet(config=ucfg)
    rng = np.random.default_rng(6)
    sample = rng.standard_normal((1, F, 4, 4, 8)).astype(np.float32)
    enc = rng.standard_normal((1, 1, 48)).astype(np.float32)
    tids = np.asarray([[6.0, 127.0, 0.02]], np.float32)
    params = seeded_params(junet, 33, jnp.asarray(sample), jnp.asarray(0.5), jnp.asarray(enc),
                           jnp.asarray(tids))
    jax_hf_export.save_component(str(tmp_path), "unet", params)
    unet = UNetSpatioTemporalConditionModel(UNetSTConfig.micro())
    assert load_hf_component(str(tmp_path / "unet"), unet) == []
    ref = np.asarray(jax.jit(lambda s, e, t: junet.apply(params, s, jnp.asarray(0.7), e, t))(
        sample, enc, tids))
    with torch.no_grad():
        out = unet.eval()(torch.from_numpy(sample), torch.tensor(0.7), torch.from_numpy(enc),
                          torch.from_numpy(tids))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_port_export_loads_into_jax_bit_for_bit(jax_tiny, port_models, tmp_path):
    save_pipeline(str(tmp_path), unet=port_models["unet"], vae=port_models["vae"],
                  image_encoder=port_models["clip"], controlnet=port_models["ctrl"])
    assert (tmp_path / "control_net" / "diffusion_pytorch_model.safetensors").exists()
    assert (tmp_path / "unet" / "config.json").exists()
    for key, sub in (("unet", "unet"), ("vae", "vae"), ("clip", "image_encoder")):
        expected = jax_tiny["params"][key]["params"]
        got = jax_hf_import.load_hf_component(str(tmp_path / sub), expected=expected)
        ref_flat, got_flat = flat(expected), flat(got)
        assert sorted(got_flat) == sorted(ref_flat), sub
        for k, v in ref_flat.items():
            assert got_flat[k].dtype == np.float32 and np.array_equal(got_flat[k], v), (sub, k)


def test_extra_keys_drop_and_missing_or_misshapen_keys_raise(jax_tiny, port_models, tmp_path):
    clip = port_models["clip"]
    sd = {k: v.clone() for k, v in clip.state_dict().items()}
    comp = tmp_path / "image_encoder"
    comp.mkdir()
    extra = "vision_model.embeddings.position_ids"
    safetensors_io.save_file(dict(sd, **{extra: torch.arange(5)[None]}),
                             str(comp / "model.safetensors"))
    assert load_hf_component(str(comp), clip) == [extra]
    _assert_same(clip.state_dict(), sd)
    # the JAX importer drops it too
    jax_hf_import.load_hf_component(str(comp), expected=jax_tiny["params"]["clip"]["params"])

    key = "visual_projection.weight"
    safetensors_io.save_file({k: v for k, v in sd.items() if k != key},
                             str(comp / "model.safetensors"))
    with pytest.raises(ValueError, match="missing"):
        load_hf_component(str(comp), clip)
    before = clip.state_dict()[key].clone()
    assert load_hf_component(str(comp), clip, strict=False) == []
    assert torch.equal(clip.state_dict()[key], before)  # kept its own value

    safetensors_io.save_file(dict(sd, **{key: sd[key][:, :-1]}), str(comp / "model.safetensors"))
    for strict in (True, False):
        with pytest.raises(ValueError, match="shape_mismatch"):
            load_hf_component(str(comp), clip, strict=strict)

