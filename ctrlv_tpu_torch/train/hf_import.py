"""Diffusers / transformers checkpoints into the port's modules.

Counterpart of ``ctrlv_tpu/train/hf_import.py::load_hf_component``. The
port's modules carry the diffusers (CLIP: transformers) parameter names, so
a component directory loads by name, with no renaming or transposing:

- every ``*.safetensors`` file of the directory is read, in sorted order,
  and merged (a later file's tensor replaces an earlier one of the same name);
- keys the module does not have are dropped, also under ``strict``, as the
  JAX importer drops them (older transformers CLIP checkpoints carry
  ``vision_model.embeddings.position_ids``), and returned;
- under ``strict`` a key the module has and the files lack raises; without
  it the module keeps its own value there;
- a tensor whose shape differs from the module's raises in either mode;
- each tensor is copied to the device of the module's own tensor and cast
  there to its dtype (a cast on the host would convert the whole checkpoint
  on the CPU first).

Files are read with ``ctrlv_tpu_torch.utils.safetensors_io``, not the
``safetensors`` package.
"""

from __future__ import annotations

import os
from typing import Dict, List

import torch

from ..utils.safetensors_io import iter_tensors, load_file


load_safetensors = load_file  # the JAX package's name: one file's tensors, on a device


@torch.no_grad()
def load_hf_component(component_dir: str, module: torch.nn.Module, strict: bool = True) -> List[str]:
    """Load a component directory into ``module`` in place; returns the keys
    of the files that the module does not have, which were dropped."""
    files = sorted(f for f in os.listdir(component_dir) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors in {component_dir}")
    state: Dict[str, torch.Tensor] = {}
    for f in files:
        state.update(iter_tensors(os.path.join(component_dir, f)))
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    mismatch = {k: (tuple(state[k].shape), tuple(own[k].shape))
                for k in own if k in state and state[k].shape != own[k].shape}
    if mismatch or (strict and missing):
        raise ValueError(
            f"{component_dir} does not fit {type(module).__name__}: missing={missing[:8]} "
            f"({len(missing)} total), shape_mismatch (file, module)="
            f"{dict(list(mismatch.items())[:4])} ({len(mismatch)} total)")
    for name, dst in own.items():
        if name in state:
            dst.copy_(state[name].to(dst.device))
    return extra
