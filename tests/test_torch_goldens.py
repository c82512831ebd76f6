"""The port against the repo's torch-side references, without JAX.

- The full-size modules' state dicts against the SVD-XT (diffusers) and
  CLIP ViT-H (transformers) manifests in tests/fixtures/svd_manifests.py:
  the same keys and shapes, so real checkpoints load with strict=True.
  Built on the meta device, so no memory is allocated.
- The frozen goldens of tests/fixtures: a full-channel UNet down block
  (320 -> 640, 10 heads) and VAE up block (512 -> 256) from an independent
  torch transliteration (make_unet_goldens.py), and transformers' tiny CLIP
  (make_goldens.py). Their state dicts load into the port as they are.

Tolerance: the JAX package's own for these goldens (atol 5e-4, rtol 2e-3
for the blocks; 2e-4 / 2e-3 for CLIP): f32 on the CPU, with another
implementation's order of sums and gelu/norm formulas.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ctrlv_tpu_torch.models import (
    AutoencoderKLTemporalDecoder,
    CLIPVisionConfig,
    CLIPVisionModelWithProjection,
    ControlNetSpatioTemporal,
    UNetSpatioTemporalConditionModel,
)
from ctrlv_tpu_torch.models.blocks_st import CrossAttnDownBlockSpatioTemporal
from ctrlv_tpu_torch.models.vae import UpBlockTemporalDecoder

FIX = Path(__file__).parent / "fixtures"
sys.path.insert(0, str(FIX))

import svd_manifests  # noqa: E402
from make_unet_goldens import (  # noqa: E402
    synthetic_sd,
    unet_downblock1_manifest,
    unet_golden_inputs,
    vae_golden_inputs,
    vae_upblock2_manifest,
)

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "build,manifest",
    [
        (UNetSpatioTemporalConditionModel, svd_manifests.svd_xt_unet_manifest),
        (ControlNetSpatioTemporal, svd_manifests.svd_xt_controlnet_manifest),
        (AutoencoderKLTemporalDecoder, svd_manifests.svd_xt_vae_manifest),
        (CLIPVisionModelWithProjection, svd_manifests.clip_vit_h_manifest),
    ],
    ids=["unet", "controlnet", "vae", "clip"],
)
def test_full_size_state_dict_matches_checkpoint_manifest(build, manifest):
    with torch.device("meta"):
        module = build()
    ours = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    expected = {k: tuple(v) for k, v in manifest().items()}
    assert sorted(set(expected) - set(ours)) == []
    assert sorted(set(ours) - set(expected)) == []
    assert {k: s for k, s in ours.items() if s != expected[k]} == {}


def _load(module, sd):
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return module.eval()


def test_unet_downblock_golden():
    golden = np.load(FIX / "golden_unet_downblock.npz")
    block = _load(
        CrossAttnDownBlockSpatioTemporal(
            320, 640, num_layers=2, num_attention_heads=10, cross_attention_dim=1024,
            add_downsample=True, temb_channels=1280,
        ),
        synthetic_sd(unet_downblock1_manifest(), seed=7),
    )
    x, temb, enc = (torch.from_numpy(a) for a in unet_golden_inputs())
    with torch.no_grad():
        out, skips = block(x.permute(0, 3, 1, 2), temb, enc, torch.zeros(1, 3))
    nhwc = lambda t: t.permute(0, 2, 3, 1).numpy()  # noqa: E731
    np.testing.assert_allclose(nhwc(out), golden["expected"], atol=5e-4, rtol=2e-3)
    np.testing.assert_allclose(nhwc(skips[0]), golden["expected_skip0"], atol=5e-4, rtol=2e-3)


def test_vae_upblock_golden():
    golden = np.load(FIX / "golden_vae_upblock.npz")
    block = _load(
        UpBlockTemporalDecoder(512, 256, num_layers=3, add_upsample=True),
        synthetic_sd(vae_upblock2_manifest(), seed=11),
    )
    (x,) = vae_golden_inputs()
    with torch.no_grad():
        out = block(torch.from_numpy(x).permute(0, 3, 1, 2), torch.zeros(1, 3))
    np.testing.assert_allclose(
        out.permute(0, 2, 3, 1).numpy(), golden["expected"], atol=5e-4, rtol=2e-3
    )


def test_clip_golden():
    golden = np.load(FIX / "golden_clip.npz")
    sd = {k[len("sd::"):]: golden[k] for k in golden.files if k.startswith("sd::")}
    model = _load(CLIPVisionModelWithProjection(CLIPVisionConfig.tiny()), sd)
    with torch.no_grad():
        out = model(torch.from_numpy(golden["img"].transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(out.numpy(), golden["expected"], atol=2e-4, rtol=2e-3)
