"""LayoutNet object-dict flatten and unflatten, and its AR rollout.

Counterpart of ``ctrlv_tpu/utils/objectnet.py``: ``convert_objects`` packs
the padded object dict into flat per-frame layout vectors of 16 numbers an
object slot, ``revert_embed`` unpacks them, and ``generate_step`` rolls a
LayoutNet out autoregressively.
"""

from __future__ import annotations

from typing import Dict

import torch

# per-object scalar layout: truncated, occluded, alpha, bbox4, dims3, loc3,
# rot_y, id_type, track_id  ->  16 numbers per object slot
OBJECT_DIM = 16


def convert_objects(objects: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Padded object dict (B, F, N, ...) -> flat layouts (B, F, N*OBJECT_DIM)."""
    parts = [
        objects["truncated"][..., None].float(),
        objects["occluded"].float()[..., None],
        objects["alpha"][..., None].float(),
        objects["bbox"].float(),
        objects["dimensions"].float(),
        objects["locations"].float(),
        objects["rotation_y"][..., None].float(),
        objects["id_type"].float()[..., None],
        objects["track_id"].float()[..., None],
    ]
    flat = torch.cat(parts, dim=-1)  # (B, F, N, 16)
    b, f, n, d = flat.shape
    return flat.reshape(b, f, n * d)


def revert_embed(layout: torch.Tensor, num_objects: int) -> Dict[str, torch.Tensor]:
    """Flat layouts (B, F, N*OBJECT_DIM) -> object dict (inverse of convert_objects)."""
    b, f, _ = layout.shape
    x = layout.reshape(b, f, num_objects, OBJECT_DIM)
    return dict(
        truncated=x[..., 0],
        occluded=x[..., 1].to(torch.int32),
        alpha=x[..., 2],
        bbox=x[..., 3:7],
        dimensions=x[..., 7:10],
        locations=x[..., 10:13],
        rotation_y=x[..., 13],
        id_type=x[..., 14].to(torch.int32),
        track_id=x[..., 15].to(torch.int32),
    )


@torch.no_grad()
def generate_step(layout_net, seed_layouts: torch.Tensor, cond: torch.Tensor,
                  steps: int) -> torch.Tensor:
    """AR rollout: feed (layout ++ cond) and append the model's next-frame
    prediction ``steps`` times. seed_layouts (B, S0, n_layout), cond (B, n_cond)."""
    layouts = seed_layouts
    for _ in range(steps):
        b, s, _ = layouts.shape
        cond_seq = cond[:, None].expand(b, s, cond.shape[-1]).to(layouts.dtype)
        pred, _ = layout_net(torch.cat([layouts, cond_seq], dim=-1))
        layouts = torch.cat([layouts, pred[:, -1:].to(layouts.dtype)], dim=1)
    return layouts
