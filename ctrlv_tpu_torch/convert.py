"""Flattened JAX params -> the port's ``state_dict``, with numpy alone.

Counterpart of ``ctrlv_tpu/train/hf_import.py::flax_params_to_torch_state_dict``
for a param tree flattened to ``{"a/b/c": ndarray}``
(``flax.traverse_util.flatten_dict(params, sep="/")``; a leading
``params/`` is dropped). The renames are the same:

- a ``name_N`` component becomes ``name.N`` (``linear_1``/``linear_2`` keep
  their names), so ``to_out_0`` becomes ``to_out.0`` and ``mlp_fc1``
  becomes ``mlp.fc1``;
- ``kernel`` becomes ``weight``, transposed: Linear (I,O) -> (O,I), Conv2d
  (kh,kw,I,O) -> (O,I,kh,kw), Conv3d (kt,kh,kw,I,O) -> (O,I,kt,kh,kw);
- ``scale`` (a norm's) becomes ``weight``;
- ``class_embedding``, ``position_embedding`` and ``mix_factor`` go
  through as they are.

``component="image_encoder"`` adds transformers' CLIP prefixes
(``vision_model.embeddings.``, ``vision_model.encoder.`` ...).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

_LITERAL_UNDERSCORE_NAMES = frozenset({"linear_1", "linear_2"})


def _clip_prefixes(name: str) -> str:
    head = name.split(".", 1)[0]
    if head == "visual_projection":
        return name
    if head in ("class_embedding", "patch_embedding", "position_embedding"):
        name = "embeddings." + name
        if name.endswith("position_embedding"):
            name += ".weight"  # an nn.Embedding in transformers
    elif head == "layers":
        name = "encoder." + name
    return "vision_model." + name


def flax_to_state_dict(
    flat_params: Mapping[str, np.ndarray], component: Optional[str] = None
) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for key, arr in flat_params.items():
        arr = np.asarray(arr)
        *prefix, leaf = key.split("/")
        if prefix and prefix[0] == "params":
            prefix = prefix[1:]
        parts = []
        for p in prefix:
            m = re.fullmatch(r"(.+?)_(\d+)", p)
            if p in ("mlp_fc1", "mlp_fc2"):
                parts += ["mlp", p[4:]]
            elif m and p not in _LITERAL_UNDERSCORE_NAMES:
                parts += [m.group(1), m.group(2)]
            else:
                parts.append(p)
        if leaf == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 5:
                arr = arr.transpose(4, 3, 0, 1, 2)
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        name = ".".join(parts + [leaf])
        if component == "image_encoder":
            name = _clip_prefixes(name)
        out[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return out
