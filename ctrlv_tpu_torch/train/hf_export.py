"""The port's modules out as a diffusers pipeline directory.

Counterpart of ``ctrlv_tpu/train/hf_export.py``: ``unet/``, ``vae/``,
``image_encoder/`` and ``control_net/`` subdirectories, each with its
weights under the file name diffusers (CLIP: transformers) looks for and a
``config.json`` of the port's config dataclass, plus ``model_index.json``.
The weights keep the module's parameter names; they load back with
``hf_import.load_hf_component`` here and in the JAX package. A trainer
writes its f32 master weights in place of the module's bf16 tensors
(``tensors``) and every other floating tensor upcast (``dtype``), as the JAX
trainers write their f32 parameters.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Mapping, Optional

import torch

from ..utils.safetensors_io import save_file

_WEIGHT_NAMES = {
    "unet": "diffusion_pytorch_model.safetensors",
    "vae": "diffusion_pytorch_model.safetensors",
    "control_net": "diffusion_pytorch_model.safetensors",
    "controlnet": "diffusion_pytorch_model.safetensors",
    "image_encoder": "model.safetensors",
}


def save_component(out_dir: str, name: str, module: torch.nn.Module,
                   tensors: Optional[Mapping[str, torch.Tensor]] = None, dtype=None) -> str:
    """Write one component; returns its directory. ``tensors`` replace the
    module's own by name; ``dtype`` casts every floating tensor."""
    comp_dir = os.path.join(out_dir, name)
    os.makedirs(comp_dir, exist_ok=True)
    state = module.state_dict()
    unknown = set(tensors or {}) - set(state)
    if unknown:
        raise KeyError(f"{name}: {sorted(unknown)[:4]} are not tensors of the module")
    state.update(tensors or {})
    if dtype is not None:
        state = {k: v.to(dtype) if v.is_floating_point() else v for k, v in state.items()}
    save_file(state, os.path.join(comp_dir, _WEIGHT_NAMES.get(name, "model.safetensors")),
              metadata={"format": "pt"})  # what transformers' loader looks for
    config = getattr(module, "config", None)
    if dataclasses.is_dataclass(config):
        with open(os.path.join(comp_dir, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(config), f, indent=2)
    return comp_dir


def save_pipeline(
    out_dir: str,
    unet: Optional[torch.nn.Module] = None,
    vae: Optional[torch.nn.Module] = None,
    image_encoder: Optional[torch.nn.Module] = None,
    controlnet: Optional[torch.nn.Module] = None,
    tensors: Optional[Dict[str, Mapping[str, torch.Tensor]]] = None,
    dtype=None,
) -> str:
    """Write the pipeline directory; components left None are not written.
    ``tensors`` maps a component's keyword (``"unet"``, ``"controlnet"``, ...)
    to tensors that replace the module's own; ``dtype`` casts every floating
    tensor of every component."""
    os.makedirs(out_dir, exist_ok=True)
    tensors = dict(tensors or {})
    for key, name, module in (("unet", "unet", unet), ("vae", "vae", vae),
                              ("image_encoder", "image_encoder", image_encoder),
                              ("controlnet", "control_net", controlnet)):
        if module is not None:
            save_component(out_dir, name, module, tensors.pop(key, None), dtype)
    if tensors:
        raise KeyError(f"tensors for components not written: {sorted(tensors)}")
    with open(os.path.join(out_dir, "model_index.json"), "w") as f:
        json.dump({"_class_name": "StableVideoControlPipeline"}, f, indent=2)
    return out_dir
