"""EMA of model parameters.

Counterpart of ``ctrlv_tpu/train/ema.py`` (diffusers' ``EMAModel`` as the
reference trainer uses it): the decay warms up as
min((1 + step) / (10 + step), max_decay). The averages are dictionaries by
parameter name, in the parameters' dtype; ``ema_update`` writes them in place,
where the JAX function returns a new tree.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .state import named_tensors


@dataclasses.dataclass
class EMAState:
    params: Dict[str, torch.Tensor]
    step: int


def ema_init(params) -> EMAState:
    """``params``: a module or a dictionary of tensors by name; the averages
    start as detached copies."""
    copies = {k: p.detach().clone() for k, p in named_tensors(params).items()}
    return EMAState(params=copies, step=0)


@torch.no_grad()
def ema_update(state: EMAState, new_params, max_decay: float = 0.9999) -> EMAState:
    step = state.step + 1
    # f32, as the JAX function computes it
    decay = min(np.float32(1.0 + step) / np.float32(10.0 + step), np.float32(max_decay))
    decay, rest = float(decay), float(np.float32(1.0) - decay)
    for name, p in named_tensors(new_params).items():
        ema = state.params[name]
        ema.copy_(ema * decay + p.detach().to(ema.dtype) * rest)
    state.step = step
    return state
