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

The metrics' networks have converters of their own, the inverses of the JAX
package's: ``i3d_flax_to_state_dict`` (FVD's I3D, pytorch-i3d's names) and
``lpips_flax_to_state_dict`` (the ``lpips`` package's names).
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


def _leaves(tree, path=()):
    """(path, leaf) pairs of a nested mapping, depth first."""
    for key, value in tree.items():
        if hasattr(value, "items"):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), value


def i3d_flax_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ``InceptionI3d`` variables (``{"params",
    "batch_stats"}``) -> a pytorch-i3d state dict for
    ``metrics.fvd.InceptionI3d``: the inverse of
    ``ctrlv_tpu/metrics/fvd.py::i3d_torch_to_flax``. Conv kernels
    (kt,kh,kw,I,O) -> (O,I,kt,kh,kw); a norm's ``scale``/``bias`` and its
    ``mean``/``var`` -> ``weight``/``bias`` and ``running_mean``/``running_var``;
    the Dense head (1024,400) -> the conv-shaped (400,1024,1,1,1)."""
    out: Dict[str, torch.Tensor] = {}
    stats = {"mean": "running_mean", "var": "running_var"}
    for collection in ("params", "batch_stats"):
        for path, leaf in _leaves(variables[collection]):
            arr = np.asarray(leaf)
            *module, name = path
            if tuple(module) == ("logits",):
                if name == "kernel":
                    arr = arr.T.reshape(arr.shape[1], arr.shape[0], 1, 1, 1)
                key = f"logits.conv3d.{'weight' if name == 'kernel' else name}"
            elif module[-1] == "conv3d":
                if name == "kernel":
                    arr, name = arr.transpose(4, 3, 0, 1, 2), "weight"
                key = ".".join(module + [name])
            elif module[-1] == "bn":
                name = stats[name] if collection == "batch_stats" else (
                    "weight" if name == "scale" else name)
                key = ".".join(module + [name])
            else:
                raise ValueError(f"unrecognised I3D variable {collection}/{'/'.join(path)}")
            out[key] = torch.tensor(arr)  # a copy: JAX's arrays are read-only
    return out


def lpips_flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ``LPIPS`` params (``{"params": ...}``) -> an
    ``lpips.LPIPS(net='alex')`` state dict for ``metrics.lpips.LPIPS``: the
    inverse of ``ctrlv_tpu/metrics/lpips.py::lpips_torch_to_flax``. Kernels
    HWIO -> OIHW at torchvision's feature indices, the scaling layer's
    (3,) -> (1,3,1,1), the heads (C,) -> (1,C,1,1)."""
    p = params["params"]

    def t(arr, shape=None):
        arr = np.asarray(arr)
        return torch.tensor(arr if shape is None else arr.reshape(shape))

    out = {"scaling_layer.shift": t(p["shift"], (1, 3, 1, 1)),
           "scaling_layer.scale": t(p["scale"], (1, 3, 1, 1))}
    for j, index in enumerate((0, 3, 6, 8, 10)):
        conv = p["net"][f"conv{j + 1}"]
        out[f"net.slice{j + 1}.{index}.weight"] = t(np.asarray(conv["kernel"]).transpose(3, 2, 0, 1))
        out[f"net.slice{j + 1}.{index}.bias"] = t(conv["bias"])
    for k in range(5):
        out[f"lin{k}.model.1.weight"] = t(p[f"lin{k}"], (1, -1, 1, 1))
    return out
