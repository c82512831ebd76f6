"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc (sm_90a) and skip without one.
On the card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: tests/conftest.py configures JAX, which a GPU host of
the port need not have; this file imports only torch and the port.)

Tolerance: bf16 operands from a seeded generator, outputs of order 1. The
kernels round P to bf16 before the product with V at other places than the
plain versions, and the outputs are bf16 (ulp 2^-8 relative), so they agree
to a few bf16 ulps: |kernel - plain| <= 1e-2 * (1 + |plain|).
"""

import pytest
import torch

from ctrlv_tpu_torch.models import layers
from ctrlv_tpu_torch.ops import mha

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
    shapes, and agrees with the same module under plain_attention()."""
    torch.manual_seed(0)
    attn = layers.Attention(320, heads=5, dim_head=64).to(cuda, torch.bfloat16)
    for x_shape, name in (((2, 1024, 320), "mha"), ((512, 25, 320), "small_mha")):
        x = torch.randn(x_shape, device=cuda, dtype=torch.bfloat16)
        before = dict(mha.LAUNCHES)
        with torch.no_grad():
            out = attn(x)
            with mha.plain_attention():
                ref = attn(x)
        torch.cuda.synchronize()
        assert mha.LAUNCHES[name] == before[name] + 1
        assert_close(out, ref)
