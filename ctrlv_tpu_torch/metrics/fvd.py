"""FVD: the Fréchet Video Distance over the features of an I3D.

Counterpart of ``ctrlv_tpu/metrics/fvd.py`` (the reference's
``metrics/fvd.py``):

- ``InceptionI3d``, the Inflated Inception-v1 with its Kinetics-400 head,
  under pytorch-i3d's names (``Conv3d_1a_7x7.conv3d.weight``,
  ``Mixed_3b.b1b.bn.running_var``, a conv-shaped head
  ``logits.conv3d.{weight,bias}`` of (400, 1024, 1, 1, 1)), so that a
  pytorch-i3d state dict loads with ``strict=True``. It reads NCDHW. Every
  convolution and max-pool pads TF's "SAME" way, as flax's do: the low side
  gets total // 2, the high side the rest, max-pools with -inf. BatchNorm in
  eval mode with eps 1e-3; the head a mean over (T, H, W), then the
  Dense layer;
- ``preprocess_fvd``: shorter side to 224 (bilinear, antialiased, as
  ``jax.image.resize``), centre crop, [0, 1] -> [-1, 1];
- ``frechet_distance`` over the (N, 400) logits, with scipy's ``sqrtm`` and
  an eps jitter on singular covariances;
- ``FVD``, which gathers the features of (real, fake) pairs and computes it.

The published I3D weights are not in the repository. Without a state dict
``FVD`` inits seeded random weights (``metrics.common.seeded_init_``): a
smoke value, which differs from the JAX package's random-weight FVD.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.resize import resize_bilinear
from .common import ieee_f32, seeded_init_


def same_padding(size: Sequence[int], kernel: Sequence[int], stride: Sequence[int]) -> tuple:
    """``F.pad``'s argument for TF "SAME" padding of the trailing
    ``len(size)`` dims: (low, high) pairs from the last dim back."""
    pad = []
    for n, k, s in reversed(list(zip(size, kernel, stride))):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pad += [total // 2, total - total // 2]
    return tuple(pad)


def max_pool_same(x, kernel: Tuple[int, int, int], stride: Tuple[int, int, int]):
    x = F.pad(x, same_padding(x.shape[2:], kernel, stride), value=-math.inf)
    return F.max_pool3d(x, kernel, stride)


class Unit3D(nn.Module):
    """Conv3d ("SAME"), then BatchNorm (eval, eps 1e-3) and ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel=(1, 1, 1), stride=(1, 1, 1),
                 use_bn: bool = True, activation: bool = True):
        super().__init__()
        self.kernel, self.stride, self.activation = tuple(kernel), tuple(stride), activation
        self.conv3d = nn.Conv3d(in_channels, out_channels, self.kernel, self.stride,
                                bias=not use_bn)
        self.bn = nn.BatchNorm3d(out_channels, eps=1e-3) if use_bn else None

    def forward(self, x):
        if self.kernel != (1, 1, 1):
            x = F.pad(x, same_padding(x.shape[2:], self.kernel, self.stride))
        x = self.conv3d(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.activation else x


class InceptionBlock(nn.Module):
    """Four branches: b0 | b1a-b1b | b2a-b2b | max-pool-b3b, concatenated."""

    def __init__(self, in_channels: int, channels: Tuple[int, ...]):
        super().__init__()
        c = channels  # (b0, b1a, b1b, b2a, b2b, b3b)
        self.b0 = Unit3D(in_channels, c[0])
        self.b1a = Unit3D(in_channels, c[1])
        self.b1b = Unit3D(c[1], c[2], (3, 3, 3))
        self.b2a = Unit3D(in_channels, c[3])
        self.b2b = Unit3D(c[3], c[4], (3, 3, 3))
        self.b3b = Unit3D(in_channels, c[5])
        self.out_channels = c[0] + c[2] + c[4] + c[5]

    def forward(self, x):
        b3 = max_pool_same(x, (3, 3, 3), (1, 1, 1))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)),
                          self.b3b(b3)], dim=1)


# (name, branch channels) of the inception blocks; a "pool" entry is the max-pool before it
_BLOCKS = (
    ("Mixed_3b", (64, 96, 128, 16, 32, 32)),
    ("Mixed_3c", (128, 128, 192, 32, 96, 64)),
    ("pool", ((3, 3, 3), (2, 2, 2))),
    ("Mixed_4b", (192, 96, 208, 16, 48, 64)),
    ("Mixed_4c", (160, 112, 224, 24, 64, 64)),
    ("Mixed_4d", (128, 128, 256, 24, 64, 64)),
    ("Mixed_4e", (112, 144, 288, 32, 64, 64)),
    ("Mixed_4f", (256, 160, 320, 32, 128, 128)),
    ("pool", ((2, 2, 2), (2, 2, 2))),
    ("Mixed_5b", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5c", (384, 192, 384, 48, 128, 128)),
)


class InceptionI3d(nn.Module):
    """I3D over (B, 3, T, H, W) in [-1, 1] -> (B, num_classes) logits."""

    def __init__(self, num_classes: int = 400):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        c = 192
        for name, spec in _BLOCKS:
            if name != "pool":
                block = InceptionBlock(c, spec)
                setattr(self, name, block)
                c = block.out_channels
        self.logits = Unit3D(c, num_classes, use_bn=False, activation=False)

    def forward(self, x):
        x = self.Conv3d_1a_7x7(x)
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        for name, spec in _BLOCKS:
            x = max_pool_same(x, *spec) if name == "pool" else getattr(self, name)(x)
        x = x.mean(dim=(2, 3, 4))  # global average over (T, H, W)
        w = self.logits.conv3d.weight
        return F.linear(x, w.reshape(w.shape[:2]), self.logits.conv3d.bias)


def preprocess_fvd(videos: torch.Tensor, target: int = 224) -> torch.Tensor:
    """(B, T, H, W, 3) in [0, 1] -> shorter side resized to ``target``,
    centre-cropped to ``target`` x ``target``, in [-1, 1]; f32."""
    b, t, h, w, c = videos.shape
    scale = target / min(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    videos = resize_bilinear(videos, (nh, nw))
    top, left = (nh - target) // 2, (nw - target) // 2
    videos = videos[:, :, top:top + target, left:left + target]
    return torch.clamp(videos * 2.0 - 1.0, -1.0, 1.0)


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray, eps: float = 1e-6) -> float:
    """The Fréchet distance between Gaussians fit to two (N, D) feature sets.

    Where N < D the covariances are singular and ``sqrtm`` of their product
    can come back non-finite; as the standard FID/FVD code does, it is then
    taken again with eps·I added to each covariance. ``sqrtm(M)`` alone:
    its ``disp`` argument is deprecated in SciPy 1.17."""
    from scipy import linalg

    mu_a, mu_b = feats_a.mean(axis=0), feats_b.mean(axis=0)
    sig_a = np.cov(feats_a, rowvar=False)
    sig_b = np.cov(feats_b, rowvar=False)
    diff = mu_a - mu_b
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the retry below handles a failure
        covmean = linalg.sqrtm(sig_a @ sig_b)
        if not np.isfinite(covmean).all():
            offset = np.eye(sig_a.shape[0]) * eps
            covmean = linalg.sqrtm((sig_a + offset) @ (sig_b + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sig_a) + np.trace(sig_b) - 2 * np.trace(covmean))


class FVD:
    """Gathers I3D features of (real, fake) video pairs; ``compute`` gives
    the FVD between the two sets.

    ``state_dict``: pytorch-i3d's (loaded strictly); None inits seeded random
    weights from ``seed``. The network runs on ``device``: None means the
    card, and raises where there is none. It runs in IEEE f32
    (``metrics.common.ieee_f32``)."""

    def __init__(self, state_dict: Optional[Dict[str, torch.Tensor]] = None, seed: int = 0,
                 device=None, batch_size: int = 8, target_size: int = 224):
        from ..pipelines.common import resolve_device

        self.device = resolve_device(device)
        model = InceptionI3d()
        if state_dict is None:
            seeded_init_(model, seed)
        else:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        self.batch_size, self.target_size = batch_size, target_size
        self._real: list = []
        self._fake: list = []

    @torch.no_grad()
    def features(self, videos) -> np.ndarray:
        """(B, T, H, W, 3) in [0, 1], numpy or a tensor -> (B, 400) f32 logits."""
        x = torch.as_tensor(videos).to(self.device, torch.float32)
        x = preprocess_fvd(x, self.target_size).permute(0, 4, 1, 2, 3).contiguous()
        outs = []
        with ieee_f32():
            for i in range(0, x.shape[0], self.batch_size):
                outs.append(self.model(x[i:i + self.batch_size]).cpu().numpy())
        return np.concatenate(outs)

    def update(self, real_videos, fake_videos) -> None:
        self._real.append(self.features(real_videos))
        self._fake.append(self.features(fake_videos))

    def compute(self) -> float:
        return frechet_distance(np.concatenate(self._real), np.concatenate(self._fake))
