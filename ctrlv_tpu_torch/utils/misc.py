"""Odds and ends of the trainers.

The port's counterpart of two functions of ``ctrlv_tpu/utils/misc.py`` (the
reference's ``utils/util.py:172-175`` and its W&B gate): ``rand_log_normal``
and ``wandb_available``. Caption tokenization and the W&B frame helpers wait
for the teaser tool that uses them.
"""

from __future__ import annotations

import torch


def rand_log_normal(generator: torch.Generator, shape, loc: float = 0.0, scale: float = 1.0):
    """Log-normal samples, f32 on the generator's device, by the inverse CDF
    of uniform draws in [1e-7, 1 - 1e-7], as the JAX function draws them."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = u * (1 - 2e-7) + 1e-7
    return torch.exp(torch.special.ndtri(u) * scale + loc)


def wandb_available() -> bool:
    try:
        import wandb  # noqa: F401

        return True
    except ImportError:
        return False
