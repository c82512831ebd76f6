"""Plain reference of the samplers' arithmetic and of the stage-1 select.

SVD's EDM Euler sampler with v-prediction (Karras sigmas, rho = 7, 700 ->
0.002, terminal 0; c_noise = ln(sigma) / 4; c_in = 1 / sqrt(sigma^2 + 1);
c_skip = 1 / (sigma^2 + 1); c_out = -sigma / sqrt(sigma^2 + 1)), the
per-frame classifier-free guidance ramp, the conditioning of the two
samplers, and Ctrl-V's selection among stage-1 candidates (darkness cleanup,
clip mask IoU on uint8 steps, the later candidate winning a tie). Written
from the published descriptions; imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch


def karras_sigmas(steps: int, sigma_min=0.002, sigma_max=700.0, rho=7.0) -> torch.Tensor:
    """``steps + 1`` descending sigmas ending in 0, float32."""
    ramp = np.linspace(0.0, 1.0, steps)
    lo, hi = sigma_min ** (1.0 / rho), sigma_max ** (1.0 / rho)
    sig = (hi + ramp * (lo - hi)) ** rho
    return torch.tensor(np.concatenate([sig, [0.0]]), dtype=torch.float32)


def c_noise(sigma) -> torch.Tensor:
    return 0.25 * torch.log(sigma)


def scale_input(x, sigma):
    return x / torch.sqrt(sigma ** 2 + 1.0)


def guidance_ramp(frames: int, minmax: torch.Tensor) -> torch.Tensor:
    """(B, 2) guidance (min, max) -> (B, F, 1, 1, 1), linear over the frames."""
    ramp = torch.linspace(0.0, 1.0, frames, device=minmax.device)
    g = minmax[:, :1] + (minmax[:, 1:] - minmax[:, :1]) * ramp[None]
    return g[..., None, None, None]


def guided(pred, ramp):
    """CFG over a (2B, ...) prediction whose first half is unconditional."""
    uncond, cond = pred.float().chunk(2)
    return uncond + ramp * (cond - uncond)


def euler_step(v, x, sigma, sigma_next):
    denoised = v * (-sigma / torch.sqrt(sigma ** 2 + 1.0)) + x / (sigma ** 2 + 1.0)
    return x + (x - denoised) / sigma * (sigma_next - sigma)


def implied_v(x, x_next, sigma, sigma_next):
    """The guided v-prediction that an Euler step from ``x`` to ``x_next``
    used: ``euler_step`` solved for v, in float64."""
    x, x_next = x.double(), x_next.double()
    sigma, sigma_next = sigma.double(), sigma_next.double()
    denoised = x - (x_next - x) * sigma / (sigma_next - sigma)
    return ((denoised - x / (sigma ** 2 + 1.0)) / (-sigma / torch.sqrt(sigma ** 2 + 1.0))).float()


def darkness_cleanup(frames, threshold=50.0 / 255.0):
    """(N, F, H, W, 3) in [0, 1]: zero the pixels whose channel sum is under
    the threshold, then the interior frames whose every pixel is over it."""
    frames = torch.where(frames.sum(-1, keepdim=True) < threshold, 0.0, frames)
    least = frames.sum(-1).amin(dim=(-2, -1))
    idx = torch.arange(frames.shape[1], device=frames.device)
    interior = (idx > 0) & (idx < frames.shape[1] - 1)
    kill = (least > threshold) & interior[None]
    return torch.where(kill[:, :, None, None, None], 0.0, frames)


def select(candidates, gt_frames):
    """(best index, per-candidate IoU as float64) of Ctrl-V's stage-1
    selection: candidates (N, F, H, W, 3) in [0, 1], ground-truth bbox frames
    (F, H, W, 3) in [-1, 1]; masks are "any channel non-zero" after the
    uint8 quantisation; the later candidate wins a tie."""
    gt = torch.floor(torch.clamp(gt_frames.float() / 2.0 + 0.5, 0.0, 1.0) * 255.0)
    cand = torch.floor(darkness_cleanup(candidates.float()) * 255.0)
    gt_mask = (gt.sum(-1) > 0).double()
    pred = (cand.sum(-1) > 0).double()
    inter = (gt_mask[None] * pred).sum(dim=(1, 2, 3))
    union = gt_mask.sum() + pred.sum(dim=(1, 2, 3)) - inter
    iou = torch.where(union > 0, inter / union, torch.ones_like(inter)).cpu()
    best = max(range(len(iou)), key=lambda i: (float(iou[i]), i))
    return best, iou


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude to 448), returned in t's dtype; a gradient passes
    through the rounding unchanged."""
    with torch.no_grad():
        scale = 448.0 / t.abs().amax().float().clamp_min(1e-30)
        q = ((t.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(t.dtype)
    return t + (q - t).detach() if t.requires_grad else q


LAYERS = (torch.nn.Linear, torch.nn.Conv2d, torch.nn.Conv3d)


@torch.no_grad()
def fp8_weights(model: torch.nn.Module) -> None:
    """Every weight of a linear or convolution layer rounded to fp8 in place."""
    for m in model.modules():
        if isinstance(m, LAYERS):
            m.weight.copy_(fp8_round(m.weight))


@torch.no_grad()
def emulate_fp8(model: torch.nn.Module) -> list:
    """The reference computed one precision below bf16: every weight of a
    linear or convolution layer, every input of one, and the queries, keys
    and values of attention rounded to fp8 (e4m3, a scale a tensor); the
    rest stays f32. Returns the hooks' handles."""
    fp8_weights(model)
    handles = []
    for name, m in model.named_modules():
        if isinstance(m, LAYERS):
            handles.append(m.register_forward_pre_hook(
                lambda mod, args: (fp8_round(args[0]),) + tuple(args[1:])))
            if name.endswith(("to_q", "to_k", "to_v", "q_proj", "k_proj", "v_proj")):
                handles.append(m.register_forward_hook(lambda mod, args, out: fp8_round(out)))
    return handles
