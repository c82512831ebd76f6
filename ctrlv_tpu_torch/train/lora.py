"""LoRA adapters over the attention projections.

Counterpart of ``ctrlv_tpu/train/lora.py`` (the reference's rank-4 PEFT LoRA
on to_q, to_k, to_v and to_out.0). The adapters are a dictionary beside the
model, ``{"<module>.lora_a": (d_in, rank), "<module>.lora_b": (rank, d_out)}``
with the JAX package's shapes, and only they train. The effective weight is

    W_eff = W + (A B)^T * scale

because ``nn.Linear`` stores W as (d_out, d_in), the transpose of the flax
kernel that the JAX package adds A B to. The adapters are f32, as JAX's
``lora_init`` gives them over the f32 parameters of its trainers; the sum is
taken in f32 and rounded once to the base weight's dtype. Where the base
weight is bf16 (the JAX trainers hold it in f32), the effective weight may
therefore differ from the JAX one's bf16 cast by one bf16 ulp. Nothing edits
the base weights in place: ``apply_lora`` builds a new dictionary, and ``lora_applied`` lets a
module compute with the effective weights, as tensors that carry the graph
back to A and B, for as long as its block lasts. The block has to span the
backward pass too where blocks are checkpointed, because their forward runs
again then.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Union

import torch

from .state import named_tensors

LORA_TARGETS = ("to_q", "to_k", "to_v", "to_out.0")


def _target_module(name: str):
    """The module path of an adapted weight, or None: ``name`` is the weight
    of a Linear called to_q, to_k, to_v or to_out.0."""
    if not name.endswith(".weight"):
        return None
    module = name[: -len(".weight")]
    if any(module == t or module.endswith("." + t) for t in LORA_TARGETS):
        return module
    return None


def lora_init(source: Union[torch.Generator, Mapping[str, torch.Tensor]], params,
              rank: int = 4) -> Dict[str, torch.Tensor]:
    """Adapters without effect: A ~ N(0, 1) / rank, B = 0, in f32 on the
    weight's device. ``source`` is the generator that draws every A, or a
    mapping ``{"<module>.lora_a": A}`` that gives them."""
    lora = {}
    for name, weight in named_tensors(params).items():
        module = _target_module(name)
        if module is None or weight.dim() != 2:
            continue
        d_out, d_in = weight.shape
        if isinstance(source, torch.Generator):
            a = torch.randn((d_in, rank), generator=source, device=source.device)
            a = (a / rank).to(weight.device, torch.float32)
        else:
            a = torch.as_tensor(source[f"{module}.lora_a"]).to(weight.device, torch.float32)
            if a.shape != (d_in, rank):
                raise ValueError(
                    f"{module}.lora_a: shape {tuple(a.shape)}, expected {(d_in, rank)}")
        lora[f"{module}.lora_a"] = a.clone().requires_grad_(True)
        lora[f"{module}.lora_b"] = torch.zeros(
            (rank, d_out), dtype=torch.float32, device=weight.device, requires_grad=True)
    return lora


def _modules(lora: Mapping[str, torch.Tensor]):
    return [k[: -len(".lora_a")] for k in lora if k.endswith(".lora_a")]


def apply_lora(params, lora: Mapping[str, torch.Tensor], scale: float = 1.0):
    """A new dictionary with W_eff = W + (A B)^T * scale for each adapted
    weight, summed in f32 and rounded once to W's dtype."""
    merged = named_tensors(params)
    for module in _modules(lora):
        delta = (lora[f"{module}.lora_a"].float() @ lora[f"{module}.lora_b"].float()).t() * scale
        weight = merged[f"{module}.weight"]
        merged[f"{module}.weight"] = (weight.float() + delta).to(weight.dtype)
    return merged


def merge_lora(params, lora: Mapping[str, torch.Tensor], scale: float = 1.0):
    """The adapters baked into detached copies of the base weights (export)."""
    with torch.no_grad():
        return {k: v.detach() for k, v in apply_lora(params, lora, scale).items()}


@contextlib.contextmanager
def lora_applied(model: torch.nn.Module, lora: Mapping[str, torch.Tensor], scale: float = 1.0):
    """Inside this block ``model`` computes with the effective weights: each
    adapted Linear gets an instance attribute ``weight`` that shadows its
    registered parameter, which stays untouched and in place."""
    owners = {module: model.get_submodule(module) for module in _modules(lora)}
    base = {f"{module}.weight": owner._parameters["weight"].detach()
            for module, owner in owners.items()}
    try:
        for name, weight in apply_lora(base, lora, scale).items():
            owners[name[: -len(".weight")]].__dict__["weight"] = weight
        yield model
    finally:
        for owner in owners.values():
            owner.__dict__.pop("weight", None)
