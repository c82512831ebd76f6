"""KittiObjectNet: the Fourier and embedding MLP object encoder (legacy path).

Counterpart of ``ctrlv_tpu/models/kitti_object_net.py``: 32-frequency
Fourier features of the 13 scalar box attributes (truncated, alpha, bbox4,
dims3, loc3, rot_y) plus learned id and occluded embeddings (64 each), then
a 3-layer SiLU MLP (``mlp.0``, ``mlp.2``, ``mlp.4``) to one ``out_dim``
token an object slot. The input is the padded object dict of the port's
collate as it is: (B, N, ...) or clip form (B, F, N, ...). It computes in
its parameters' dtype and reaches no kernel.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..utils.fourier import FourierEmbedder

FOURIER_FREQS = 32
NUM_ATTRIBUTES = 13


class KittiObjectNet(nn.Module):
    def __init__(self, out_dim: int, num_id_classes: int = 9, num_occluded_classes: int = 5,
                 mid_dim: int = 2048):
        super().__init__()
        self.num_occluded_classes = num_occluded_classes
        self.fourier = FourierEmbedder(num_freqs=FOURIER_FREQS)
        self.id_embedder = nn.Embedding(num_id_classes, 2 * FOURIER_FREQS)
        self.occluded_embedder = nn.Embedding(num_occluded_classes, 2 * FOURIER_FREQS)
        in_dim = (NUM_ATTRIBUTES + 2) * 2 * FOURIER_FREQS
        self.mlp = nn.Sequential(
            nn.Linear(in_dim, mid_dim), nn.SiLU(), nn.Linear(mid_dim, mid_dim), nn.SiLU(),
            nn.Linear(mid_dim, out_dim),
        )

    def forward(self, objects: dict) -> torch.Tensor:
        id_type = objects["id_type"]
        is_clip = id_type.dim() == 3
        lead = id_type.shape[:2]

        def flat(x):
            return x.reshape((-1,) + tuple(x.shape[2:])) if is_clip else x

        fourier_input = torch.cat(
            [
                flat(objects["truncated"]).float()[..., None],
                flat(objects["alpha"]).float()[..., None],
                flat(objects["bbox"]).float(),
                flat(objects["dimensions"]).float(),
                flat(objects["locations"]).float(),
                flat(objects["rotation_y"]).float()[..., None],
            ],
            dim=-1,
        )  # (B, N, 13)
        b, n = fourier_input.shape[:2]
        fourier_embed = self.fourier(fourier_input).reshape(b, n, -1)  # (B, N, 13*2*FF)
        id_embed = self.id_embedder(flat(id_type).long())
        occluded = torch.clamp(flat(objects["occluded"]).long(), 0,
                               self.num_occluded_classes - 1)
        occ_embed = self.occluded_embedder(occluded)
        x = torch.cat([fourier_embed, id_embed, occ_embed], dim=-1)
        x = self.mlp(x.to(self.mlp[0].weight.dtype))
        return x.reshape(tuple(lead) + tuple(x.shape[1:])) if is_clip else x
