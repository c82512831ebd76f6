"""Plain float32 reference of Ctrl-V's ControlNet training step and of the
optimizer's update.

One micro-step (the paper's stage-2 training, from the published SVD
fine-tuning recipe): the clip and its bbox clip through the VAE encoder,
each latent sampled (mean + std * noise, log-variance clipped to [-30, 20]),
the clip's latents scaled; the first frame's sampled latent as the image
conditioning on every frame and its CLIP embedding; a sigma drawn from the
1000-entry table of the scaled-linear beta schedule; EDM noising and input
scaling; InstructPix2Pix conditioning dropout (the CLIP context zeroed
where u < 2p, the image latents where p <= u < 3p); the ControlNet on the
bbox latents into the frozen UNet; the v-prediction EDM loss weighted by
(1 + sigma^2) / sigma^2, its mean over the elements and the clips.

The update is AdamW as optax computes it (global-norm clipping, both
moments, bias correction, decoupled weight decay) on the mean of the
accumulated micro-step gradients, on float32 masters.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from .sampling import c_noise


def training_sigmas(n: int = 1000, beta_start: float = 0.00085, beta_end: float = 0.012):
    """sqrt((1 - abar) / abar) of the scaled-linear schedule, noisiest first, float32."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, n) ** 2
    abar = np.cumprod(1.0 - betas)
    return torch.tensor(np.sqrt((1.0 - abar) / abar)[::-1].copy(), dtype=torch.float32)


def sample_latents(vae, frames, noise, chunk: int):
    """(N, H, W, 3) -> sampled latents (N, h, w, c), encoded ``chunk`` frames a call."""
    c = vae.cfg["latent_channels"]
    out = []
    for i in range(0, frames.shape[0], chunk):
        moments = vae.encode_moments(frames[i:i + chunk])
        mean, logvar = moments[..., :c], moments[..., c:]
        out.append(mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise[i:i + chunk].float())
    return torch.cat(out)


def controlnet_loss(models: dict, clips, bbox, draws: dict, p: dict):
    """The loss of one micro-step; the graph reaches the ControlNet's
    parameters through the UNet. ``p``: the traffic's training parameters."""
    unet, ctrl, vae, clip = models["unet"], models["controlnet"], models["vae"], models["clip"]
    b, f = clips.shape[:2]
    chunk = p["encode_chunk"]
    with torch.no_grad():
        flat = clips.reshape(b * f, *clips.shape[2:]).float()
        target = sample_latents(vae, flat, draws["latent_noise"], chunk)
        target = target.reshape(b, f, *target.shape[1:]) * vae.cfg["scaling_factor"]
        init = sample_latents(vae, clips[:, 0].float(), draws["init_noise"], chunk)
        context = clip(clips[:, 0].float())[:, None]
        cond = sample_latents(vae, bbox.reshape(b * f, *bbox.shape[2:]).float(),
                              draws["cond_noise"], chunk).reshape(b, f, *init.shape[1:])
        image = init[:, None].expand(b, f, *init.shape[1:])
        sigma = training_sigmas().to(clips.device)[draws["sigma_idx"].long()]
        s5 = sigma[:, None, None, None, None]
        noisy = target + draws["noise"].float() * s5
        inp = noisy / torch.sqrt(s5 ** 2 + 1.0)
        u, drop = draws["dropout_u"].float(), p["conditioning_dropout"]
        context = torch.where((u < 2 * drop)[:, None, None], torch.zeros_like(context), context)
        keep = 1.0 - ((u >= drop) & (u < 3 * drop)).float()
        image = image * keep[:, None, None, None, None]
        ids = torch.tensor([[p["fps"] - 1, p["motion_bucket_id"], p["noise_aug"]]],
                           device=clips.device).repeat(b, 1)
        model_in = torch.cat([inp, image], dim=-1)
    t = c_noise(sigma)
    down, mid = ctrl(model_in, t, context, ids, cond)
    pred = unet(model_in, t, context, ids, down, mid)
    c_skip, c_out = 1.0 / (s5 ** 2 + 1.0), -s5 / torch.sqrt(s5 ** 2 + 1.0)
    weight = (1.0 + s5 ** 2) / s5 ** 2
    per_clip = (weight * (pred * c_out + c_skip * noisy - target) ** 2).reshape(b, -1).mean(1)
    return per_clip.mean()


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float) -> Dict[str, torch.Tensor]:
    """The gradients as optax's ``clip_by_global_norm`` passes them on."""
    norm = math.sqrt(sum(float(g.double().square().sum()) for g in grads.values()))
    scale = 1.0 if norm < max_norm else max_norm / norm
    return {name: g.float() * scale for name, g in grads.items()}


def adamw_init(params: Dict[str, torch.Tensor]) -> dict:
    def zeros():
        return {n: torch.zeros_like(w, dtype=torch.float32) for n, w in params.items()}

    return {"count": 0, "mu": zeros(), "nu": zeros()}


@torch.no_grad()
def adamw_update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], state: dict,
                 p: dict) -> Dict[str, torch.Tensor]:
    """One update of optax's adamw on already clipped ``grads``: both moments
    (``state``, updated in place), their bias corrections at the update's
    count, decoupled weight decay. Moves ``params`` in place and returns
    each one's change."""
    b1, b2, eps = p["adam_beta1"], p["adam_beta2"], p["adam_epsilon"]
    state["count"] += 1
    bc1, bc2 = 1.0 - b1 ** state["count"], 1.0 - b2 ** state["count"]
    out = {}
    for name, w in params.items():
        g = grads[name]
        mu = state["mu"][name].mul_(b1).add_(g, alpha=1.0 - b1)
        nu = state["nu"][name].mul_(b2).addcmul_(g, g, value=1.0 - b2)
        out[name] = -p["learning_rate"] * ((mu / bc1) / (torch.sqrt(nu / bc2) + eps)
                                           + p["weight_decay"] * w.float())
        w.add_(out[name].to(w.dtype))
    return out
