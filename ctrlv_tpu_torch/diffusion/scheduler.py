"""EDM / Euler-discrete scheduler of Stable Video Diffusion.

Counterpart of ``ctrlv_tpu/diffusion/scheduler.py``: Karras sigmas (rho = 7,
700 -> 0.002, terminal 0), the EDM c_noise timestep 0.25 * ln(sigma),
c_in = 1 / sqrt(sigma^2 + 1), the v-prediction Euler step, and the training
sigma table of the scaled-linear beta schedule. Tables are numpy; the
step functions take tensors, with sigma as an f32 tensor so that the
arithmetic is the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def karras_sigmas(num_steps: int, sigma_min: float = 0.002, sigma_max: float = 700.0,
                  rho: float = 7.0) -> np.ndarray:
    """``num_steps + 1`` descending sigmas: [sigma_max, ..., sigma_min, 0]."""
    ramp = np.linspace(0.0, 1.0, num_steps, dtype=np.float64)
    min_inv_rho = sigma_min ** (1.0 / rho)
    max_inv_rho = sigma_max ** (1.0 / rho)
    sigmas = (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho
    return np.concatenate([sigmas, [0.0]]).astype(np.float32)


def training_sigma_table(num_train_timesteps: int = 1000, beta_start: float = 0.00085,
                         beta_end: float = 0.012) -> np.ndarray:
    """The training sigmas sqrt((1 - abar_t) / abar_t) of the scaled-linear
    beta schedule, descending (index 0 is the noisiest), f32."""
    betas = np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float64) ** 2
    alphas_cumprod = np.cumprod(1.0 - betas)
    sigmas = np.sqrt((1.0 - alphas_cumprod) / alphas_cumprod)
    return sigmas[::-1].astype(np.float32)


def scale_model_input(sample, sigma):
    """EDM c_in preconditioning: x / sqrt(sigma^2 + 1)."""
    return sample / torch.sqrt(sigma**2 + 1.0)


def edm_scalings(sigma):
    """(c_skip, c_out, weighting) for v-prediction EDM."""
    c_skip = 1.0 / (sigma**2 + 1.0)
    c_out = -sigma / torch.sqrt(sigma**2 + 1.0)
    weighting = (1.0 + sigma**2) / sigma**2
    return c_skip, c_out, weighting


def euler_step(model_output, sample, sigma, sigma_next):
    """One Euler step x_t -> x_{t-1} with v-prediction."""
    c_skip, c_out, _ = edm_scalings(sigma)
    pred_original = model_output * c_out + sample * c_skip
    derivative = (sample - pred_original) / sigma
    return sample + derivative * (sigma_next - sigma)


@dataclasses.dataclass(frozen=True)
class SchedulerState:
    """Sigma and timestep tables of one sampling run, f32 tensors."""

    sigmas: torch.Tensor  # (num_steps + 1,) descending, terminal 0
    timesteps: torch.Tensor  # (num_steps,) = 0.25 * log(sigma)
    init_noise_sigma: torch.Tensor  # sqrt(sigma_max^2 + 1)


@dataclasses.dataclass(frozen=True)
class EulerDiscreteScheduler:
    """SVD's EulerDiscreteScheduler for sampling: Karras sigmas, v-prediction."""

    sigma_min: float = 0.002
    sigma_max: float = 700.0
    rho: float = 7.0

    def set_timesteps(self, num_inference_steps: int, device=None) -> SchedulerState:
        sigmas = karras_sigmas(num_inference_steps, self.sigma_min, self.sigma_max, self.rho)
        timesteps = (0.25 * np.log(sigmas[:-1])).astype(np.float32)
        init_noise_sigma = np.sqrt(sigmas[0] ** 2 + 1.0).astype(np.float32)
        return SchedulerState(
            sigmas=torch.from_numpy(sigmas).to(device),
            timesteps=torch.from_numpy(timesteps).to(device),
            init_noise_sigma=torch.from_numpy(np.asarray(init_noise_sigma)).to(device),
        )
