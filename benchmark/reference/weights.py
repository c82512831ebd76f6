"""Seeded random weights, made on the device in a few large calls.

The rule is that of the program's bench (``ctrlv_tpu_torch/tools/bench.py::
init_random_``, copied here so that a later change there cannot move the
yardstick): matrices and kernels N(0, 1/fan_in), the CLIP class embedding
N(0, 0.02), biases 0, norm weights 1, the blend factors at their
constructor's value. One standard-normal draw fills one flat buffer for a
whole model; the scales are applied by one multi-tensor multiply. The same
seed on the same device gives the same bits, so the program and the
reference are handed the same weights, each building its own copy.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from .svd import AlphaBlender

ALIGN = 64  # elements: every tensor starts 128-byte aligned, as the program's kernels want


def _groups(model: nn.Module):
    """Names of the model's parameters, with how each is initialised:
    ("normal", std), ("const", value)."""
    alphas = {f"{name}.mix_factor": m.init_alpha for name, m in model.named_modules()
              if isinstance(m, AlphaBlender)}
    rules = {}
    for name, p in model.named_parameters():
        if name in alphas:
            rules[name] = ("const", alphas[name])
        elif p.dim() >= 2:
            rules[name] = ("normal", p[0].numel() ** -0.5)
        elif name.endswith("class_embedding"):
            rules[name] = ("normal", 0.02)
        elif name.endswith("bias"):
            rules[name] = ("const", 0.0)
        else:
            rules[name] = ("const", 1.0)
    return rules


@torch.no_grad()
def make_weights(model: nn.Module, seed: int, device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """{name: tensor} for every parameter of ``model`` (a reference model, on
    any device, ``meta`` included), views of one flat ``dtype`` buffer on
    ``device`` drawn from ``seed``."""
    rules = _groups(model)
    shapes = {name: p.shape for name, p in model.named_parameters()}
    offsets, total = {}, 0
    for name, shape in shapes.items():
        offsets[name] = total
        total += -(-shape.numel() // ALIGN) * ALIGN
    flat = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat.normal_(0.0, 1.0, generator=gen)
    views = {name: flat[offsets[name]:offsets[name] + shape.numel()].view(shape)
             for name, shape in shapes.items()}
    normal = [n for n, r in rules.items() if r[0] == "normal"]
    torch._foreach_mul_([views[n] for n in normal], [rules[n][1] for n in normal])
    const = [n for n, r in rules.items() if r[0] == "const"]
    torch._foreach_mul_([views[n] for n in const], 0.0)
    torch._foreach_add_([views[n] for n in const], [rules[n][1] for n in const])
    return views


def model_seed(seed: int, model: str) -> int:
    """The weights' seed of one model of a run: the run's seed and the model's name."""
    h = 0
    for ch in model.encode():
        h = (h * 131 + ch) % (1 << 31)
    return (seed * 1_000_003 + h) % (1 << 63)


@torch.no_grad()
def load_reference(model: nn.Module, weights: Dict[str, torch.Tensor], device) -> nn.Module:
    """``model`` (built on ``meta``) materialised on ``device`` in float32 with
    ``weights``, upcast."""
    model = model.to_empty(device=device).float()
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"weights do not match the model: {sorted(set(params) ^ set(weights))[:5]}")
    names = list(params)
    torch._foreach_copy_([params[n] for n in names], [weights[n] for n in names])
    return model.eval().requires_grad_(False)
