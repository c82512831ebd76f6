"""Which attention the port's ``Attention`` takes under each
``--attention_impl``.

In the JAX package ``"xla"`` sends all four attention sites to XLA's
attention (``ctrlv_tpu/models/layers.py``: the frames-major, spatial and
temporal kernels are gated on ``get_attention_impl() != "xla"``;
``ops/attention.py`` gates the one-pass kernel). The port does the same: its
three ``ops/mha.py`` wrappers are replaced by recorders here, since on the
CPU every wrapper computes its plain version and only a recorder can see the
route.

Tolerance: under ``"xla"`` each site computes the same f32 attention through
``dot_product_attention`` (the plain version on the CPU) in another order of
sums, so 1e-5 absolute on outputs of order 1.
"""

import pytest
import torch

from ctrlv_tpu_torch.models import layers
from ctrlv_tpu_torch.ops import attention, mha

torch.set_num_threads(1)

# site: (wrapper the site takes under "auto", input shape, temporal_frames)
SITES = {
    "spatial": ("mha_attention", (1, 1024, 64), None),  # K1: S >= 1024
    "temporal": ("small_mha_attention", (256, 5, 64), None),  # K2: 5 frames, 256 pixels
    "frames_major": ("small_mha_attention_fm", (5, 256, 64), 5),  # K3: (B*F, S, C)
}
WRAPPERS = ("mha_attention", "small_mha_attention", "small_mha_attention_fm")


def _record(monkeypatch):
    calls = []
    for name in WRAPPERS:
        real = getattr(mha, name)
        monkeypatch.setattr(mha, name,
                            lambda *a, _n=name, _r=real: calls.append(_n) or _r(*a))
    return calls


@pytest.mark.parametrize("site", sorted(SITES))
def test_xla_leaves_the_mha_kernels_off(monkeypatch, site):
    """Under "xla" no wrapper of ``ops/mha.py`` is called and the output is
    the "auto" one; under "auto" the site's own wrapper is called once."""
    wrapper, shape, frames = SITES[site]
    torch.manual_seed(0)
    attn = layers.Attention(64, heads=1, dim_head=64)
    x = torch.randn(shape)
    calls = _record(monkeypatch)
    assert attention.get_attention_impl() == "auto"
    try:
        with torch.no_grad():
            auto = attn(x, temporal_frames=frames)
            assert calls == [wrapper]
            calls.clear()
            attention.set_attention_impl("xla")
            xla = attn(x, temporal_frames=frames)
    finally:
        attention.set_attention_impl("auto")
    assert calls == []
    torch.testing.assert_close(xla, auto, rtol=0, atol=1e-5)


def test_xla_takes_the_library_attention(monkeypatch):
    """Under "xla" every site reaches ``library_attention`` (SDPA on the card)
    and never the one-pass kernel's wrapper."""
    seen = []
    real = attention.library_attention
    monkeypatch.setattr(attention, "library_attention",
                        lambda q, *a: seen.append(tuple(q.shape)) or real(q, *a))
    monkeypatch.setattr(attention, "flash_attention",
                        lambda *a: pytest.fail("flash_attention under xla"))
    torch.manual_seed(0)
    attn = layers.Attention(64, heads=1, dim_head=64)
    try:
        attention.set_attention_impl("xla")
        with torch.no_grad():
            for _, shape, frames in SITES.values():
                attn(torch.randn(shape), temporal_frames=frames)
    finally:
        attention.set_attention_impl("auto")
    # the frames-major site reaches it as (B*S, F, H, D)
    assert seen == [(1, 1024, 1, 64), (256, 5, 1, 64), (256, 5, 1, 64)]
