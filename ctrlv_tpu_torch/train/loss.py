"""EDM training loss, sigma draws and conditioning dropout.

Counterpart of ``ctrlv_tpu/train/loss.py``: a uniform random index into the
1000-entry training sigma table, the v-prediction combined as
denoised = c_out * pred + c_skip * x_t, the squared error against the clean
latents weighted by (1 + s^2) / s^2, the mean per sample and then over the
batch; and InstructPix2Pix-style conditioning dropout: the CLIP context is
zeroed where rp < 2p, the VAE conditioning where p <= rp < 3p.

Where the JAX functions take a key, these take a ``torch.Generator`` or the
draw itself (``idx``, ``rp``), so that a test can hand both frameworks the
same numbers.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..diffusion.scheduler import edm_scalings, training_sigma_table


def sample_training_sigmas(batch_size: int, sigmas_table=None,
                           generator: Optional[torch.Generator] = None, device=None, idx=None):
    """Uniform random sigma draws: (sigma (B,), the c_noise timestep (B,)).
    ``idx`` (B,) gives the table indices instead of drawing them."""
    if sigmas_table is None:
        sigmas_table = torch.from_numpy(training_sigma_table())
    table = torch.as_tensor(sigmas_table, dtype=torch.float32, device=device)
    if idx is None:
        idx = torch.randint(0, table.shape[0], (batch_size,), generator=generator,
                            device=table.device)
    sigma = table[torch.as_tensor(idx, device=table.device).long()]
    return sigma, 0.25 * torch.log(sigma)


def conditioning_dropout(clip_emb, cond_latents, prob: float,
                         generator: Optional[torch.Generator] = None, rp=None):
    """clip_emb (B, 1, D), cond_latents (B, F, h, w, 4); ``rp`` (B,) gives
    the uniforms instead of drawing them."""
    batch = clip_emb.shape[0]
    if rp is None:
        rp = torch.rand(batch, generator=generator, device=clip_emb.device)
    rp = torch.as_tensor(rp, dtype=torch.float32, device=clip_emb.device)
    drop_prompt = (rp < 2 * prob)[:, None, None]
    clip_emb = torch.where(drop_prompt, torch.zeros_like(clip_emb), clip_emb)
    keep_image = 1.0 - ((rp >= prob) & (rp < 3 * prob)).to(cond_latents.dtype)
    return clip_emb, cond_latents * keep_image[:, None, None, None, None]


def edm_denoising_loss(model_pred, noisy_latents, target_latents, sigma):
    """model_pred (B, F, h, w, 4), the v-prediction; sigma (B,). f32 throughout."""
    sigma5 = sigma.float()[:, None, None, None, None]
    c_skip, c_out, weighting = edm_scalings(sigma5)
    denoised = model_pred.float() * c_out + c_skip * noisy_latents.float()
    sq = (denoised - target_latents.float()) ** 2
    per_sample = (weighting * sq).reshape(target_latents.shape[0], -1).mean(dim=1)
    return per_sample.mean()
