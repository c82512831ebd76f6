"""LPIPS with the AlexNet trunk, under the ``lpips`` package's parameter names.

Counterpart of ``ctrlv_tpu/metrics/lpips.py`` (the reference scores
generated against ground-truth frames with ``lpips.LPIPS(net='alex')``,
``metrics/fvd.py:240-248``). The forward is the package's:

    x' = (x - shift) / scale                      # scaling_layer buffers
    f_k = relu features of torchvision's AlexNet at relu1..relu5
    n_k = f_k / (||f_k||_2 over channels + 1e-10)
    out = sum_k spatial_mean(lin_k((n_k(x0) - n_k(x1))^2))   # 1x1, no bias

The module's names are the package's: ``scaling_layer.{shift,scale}``
buffers, ``net.slice{1..5}`` as ``nn.Sequential``s whose children sit at
torchvision's ``features`` indices (convs at 0, 3, 6, 8, 10; VALID 3x3
max-pools of stride 2 at 2 and 5), and ``lin{k}.model.1.weight`` behind a
dropout at ``model.0``. A state dict of ``lpips.LPIPS(net='alex')`` loads
with ``strict=True``. The published weights are not in the repository:
``load_lpips_torch_weights`` reads them where a user has them, and
``lpips_init_params`` gives seeded random ones, a smoke metric only.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import torch
import torch.nn as nn

from .common import ieee_f32, seeded_init_

# torchvision AlexNet feature channels at relu1..relu5
_ALEX_CHANNELS = (64, 192, 384, 256, 256)
# (out channels, kernel, stride, padding) of each conv
_ALEX_CONVS = ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1))
# torchvision's index of each slice's conv; a max-pool sits just before those of slices 2, 3
_CONV_INDEX = (0, 3, 6, 8, 10)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class ScalingLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1))

    def forward(self, x):
        return (x - self.shift) / self.scale


class AlexNetSlices(nn.Module):
    """torchvision AlexNet's ``features`` cut after each ReLU: relu1..relu5."""

    def __init__(self):
        super().__init__()
        in_ch = 3
        for s, (i, (out_ch, k, stride, pad)) in enumerate(zip(_CONV_INDEX, _ALEX_CONVS), start=1):
            layers = OrderedDict()
            if s in (2, 3):
                layers[str(i - 1)] = nn.MaxPool2d(3, 2)
            layers[str(i)] = nn.Conv2d(in_ch, out_ch, k, stride, pad)
            layers[str(i + 1)] = nn.ReLU()
            setattr(self, f"slice{s}", nn.Sequential(layers))
            in_ch = out_ch

    def forward(self, x):
        feats = []
        for s in range(1, 6):
            x = getattr(self, f"slice{s}")(x)
            feats.append(x)
        return feats


class NetLinLayer(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(channels, 1, 1, bias=False))

    def forward(self, x):
        return self.model(x)


class LPIPS(nn.Module):
    """LPIPS distance of two NCHW batches in [-1, 1] -> (B,). Built in eval
    mode (the dropouts are identities)."""

    def __init__(self):
        super().__init__()
        self.scaling_layer = ScalingLayer()
        self.net = AlexNetSlices()
        for k, c in enumerate(_ALEX_CHANNELS):
            setattr(self, f"lin{k}", NetLinLayer(c))
        self.eval()

    def forward(self, x0, x1):
        f0 = self.net(self.scaling_layer(x0))
        f1 = self.net(self.scaling_layer(x1))
        total = 0.0
        for k, (a, b) in enumerate(zip(f0, f1)):
            na = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-10)
            nb = b / (torch.linalg.vector_norm(b, dim=1, keepdim=True) + 1e-10)
            total = total + getattr(self, f"lin{k}")((na - nb) ** 2).mean(dim=(2, 3))
        return total[:, 0]


def lpips_init_params(seed: int = 0) -> Dict[str, torch.Tensor]:
    """A seeded random state dict (a smoke metric only), made as the JAX
    package's ``lpips_init_params`` makes its params: convs lecun-normal,
    biases 0, the linear heads 1; the draws are not JAX's."""
    model = seeded_init_(LPIPS(), seed)
    with torch.no_grad():
        for k in range(len(_ALEX_CHANNELS)):
            getattr(model, f"lin{k}").model[1].weight.fill_(1.0)
    return model.state_dict()


def load_lpips_torch_weights(path: str) -> Dict[str, torch.Tensor]:
    """A saved state dict of ``lpips.LPIPS(net='alex')``, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def build_lpips(state_dict: Dict[str, torch.Tensor], device=None) -> LPIPS:
    """An ``LPIPS`` with ``state_dict`` loaded strictly, on ``device``: None
    means the card, and raises where there is none."""
    from ..pipelines.common import resolve_device

    model = LPIPS()
    model.load_state_dict(state_dict, strict=True)
    return model.to(resolve_device(device))


@torch.no_grad()
def lpips_distance(model: LPIPS, img0, img1) -> torch.Tensor:
    """LPIPS over (B, H, W, 3) batches in [-1, 1] -> (B,) f32 on the
    model's device, in IEEE f32."""
    device = next(model.parameters()).device
    x0 = torch.as_tensor(img0).to(device, torch.float32).permute(0, 3, 1, 2)
    x1 = torch.as_tensor(img1).to(device, torch.float32).permute(0, 3, 1, 2)
    with ieee_f32():
        return model(x0.contiguous(), x1.contiguous())
