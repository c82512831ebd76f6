"""The port's modules out as a diffusers pipeline directory.

Counterpart of ``ctrlv_tpu/train/hf_export.py``: ``unet/``, ``vae/``,
``image_encoder/`` and ``control_net/`` subdirectories, each with its
weights under the file name diffusers (CLIP: transformers) looks for and a
``config.json`` of the port's config dataclass, plus ``model_index.json``.
The weights keep the module's parameter names and dtype; they load back with
``hf_import.load_hf_component`` here and in the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import torch

from ..utils.safetensors_io import save_file

_WEIGHT_NAMES = {
    "unet": "diffusion_pytorch_model.safetensors",
    "vae": "diffusion_pytorch_model.safetensors",
    "control_net": "diffusion_pytorch_model.safetensors",
    "controlnet": "diffusion_pytorch_model.safetensors",
    "image_encoder": "model.safetensors",
}


def save_component(out_dir: str, name: str, module: torch.nn.Module) -> str:
    """Write one component; returns its directory."""
    comp_dir = os.path.join(out_dir, name)
    os.makedirs(comp_dir, exist_ok=True)
    save_file(module.state_dict(), os.path.join(comp_dir, _WEIGHT_NAMES.get(name, "model.safetensors")),
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
) -> str:
    """Write the pipeline directory; components left None are not written."""
    os.makedirs(out_dir, exist_ok=True)
    for name, module in (("unet", unet), ("vae", vae), ("image_encoder", image_encoder),
                         ("control_net", controlnet)):
        if module is not None:
            save_component(out_dir, name, module)
    with open(os.path.join(out_dir, "model_index.json"), "w") as f:
        json.dump({"_class_name": "StableVideoControlPipeline"}, f, indent=2)
    return out_dir
