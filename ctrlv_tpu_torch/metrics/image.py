"""SSIM and PSNR of images, channels last.

Counterpart of ``ctrlv_tpu/metrics/image.py`` (the reference's per-frame
skimage SSIM / PSNR, ``metrics/fvd.py:187-289``): SSIM with the Gaussian
window of Wang et al. (11 taps, sigma 1.5, K1 = 0.01, K2 = 0.03), valid
filtering, averaged over pixels and channels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    mse = torch.mean((a.float() - b.float()) ** 2)
    return 10.0 * torch.log10(data_range**2 / mse)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x**2) / (2 * sigma**2))
    return g / g.sum()


def _filter2d_sep(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Separable valid-mode filter of (1, C, H, W), channel by channel."""
    c, k = img.shape[1], kernel.shape[0]
    img = F.conv2d(img, kernel.view(1, 1, 1, k).expand(c, 1, 1, k), groups=c)
    return F.conv2d(img, kernel.view(1, 1, k, 1).expand(c, 1, k, 1), groups=c)


def ssim(
    a: torch.Tensor,
    b: torch.Tensor,
    data_range: float = 1.0,
    win_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Mean SSIM of one (H, W, C) image pair."""
    a = a.float().permute(2, 0, 1)[None]
    b = b.float().permute(2, 0, 1)[None]
    kernel = _gaussian_kernel(win_size, sigma, a.device)
    mu_a = _filter2d_sep(a, kernel)
    mu_b = _filter2d_sep(b, kernel)
    mu_aa = _filter2d_sep(a * a, kernel)
    mu_bb = _filter2d_sep(b * b, kernel)
    mu_ab = _filter2d_sep(a * b, kernel)
    var_a = mu_aa - mu_a**2
    var_b = mu_bb - mu_b**2
    cov = mu_ab - mu_a * mu_b
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)
    return torch.mean(num / den)
