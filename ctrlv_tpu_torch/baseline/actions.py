"""Action discretization and data processing for the AR bbox baseline.

Counterpart of ``ctrlv_tpu/baseline/actions.py``: polar displacement actions
of the two box corners (24 direction bins x 16 norm bins = a vocabulary of
384, norms clipped to 0.1), bbox <-> action conversions, the coordinate-token
variant, track-id slot alignment (``normalize_track_ids``, the JAX package's
numpy), leaving-frame smoothing and ``process_data``.

The arithmetic is the JAX package's in f32: ``torch.round`` rounds half to
even as ``jnp.round`` does, ``torch.remainder`` is ``jnp.mod``, and
``reshape_data`` is the same scatter-*add* (null rows add zeros to slot 0).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..pipelines.common import resolve_device

DIR_DISCRETIZATION = 24
NORM_DISCRETIZATION = 16
MAX_DIR = 2 * np.pi
MIN_DIR = 0.0
MAX_NORM = 0.1
MIN_NORM = 0.0


def discretize_actions(actions, dir_disc=DIR_DISCRETIZATION, norm_disc=NORM_DISCRETIZATION):
    """(..., 2, 2) continuous (direction, norm) -> (..., 2) tokens (float)."""
    d = torch.clamp(actions[..., 0], MIN_DIR, MAX_DIR)
    n = torch.clamp(actions[..., 1], MIN_NORM, MAX_NORM)
    d = torch.round((d - MIN_DIR) / (MAX_DIR - MIN_DIR) * (dir_disc - 1))
    n = torch.round((n - MIN_NORM) / (MAX_NORM - MIN_NORM) * (norm_disc - 1))
    return d * norm_disc + n


def undiscretize_actions(tokens, dir_disc=DIR_DISCRETIZATION, norm_disc=NORM_DISCRETIZATION):
    """(..., 2) tokens -> (..., 2, 2) continuous (direction, norm)."""
    d = torch.div(tokens, norm_disc, rounding_mode="floor")
    n = torch.remainder(tokens, norm_disc)
    d = d / (dir_disc - 1) * (MAX_DIR - MIN_DIR) + MIN_DIR
    n = n / (norm_disc - 1) * (MAX_NORM - MIN_NORM) + MIN_NORM
    return torch.stack([d, n], dim=-1)


def discretize_coords(coords, vocabulary_size: int):
    return torch.round(torch.clamp(coords, 0.0, 1.0) * (vocabulary_size - 1)).to(torch.int32)


def undiscretize_coords(tokens, vocabulary_size: int):
    return tokens.float() / (vocabulary_size - 1)


def bbox_seq_to_actions(bboxes: torch.Tensor) -> torch.Tensor:
    """(B, T, N, 4) -> (B, T, N, 2, 2) polar corner displacements.

    The action at t is the move from t-1 to t; [.., 0] is the top-left
    corner, [.., 1] the bottom-right. The action at t=0 is zero.
    """
    d = bboxes[:, 1:] - bboxes[:, :-1]  # (B, T-1, N, 4): dx1, dy1, dx2, dy2
    dx = torch.stack([d[..., 0], d[..., 2]], dim=-1)
    dy = torch.stack([d[..., 1], d[..., 3]], dim=-1)
    direction = torch.remainder(torch.atan2(dy, dx) + 2 * np.pi, 2 * np.pi)
    norm = torch.sqrt(dx**2 + dy**2)
    actions = torch.stack([direction, norm], dim=-1)  # (B, T-1, N, 2, 2)
    return torch.cat([torch.zeros_like(actions[:, :1]), actions], dim=1)


def actions_to_bbox_seq(
    actions: torch.Tensor, initial_bboxes: torch.Tensor, discard_first_action: bool = False
) -> torch.Tensor:
    """(B, T, N, 2, 2) + (B, N, 4) -> (B, T, N, 4) by cumulative sums."""
    direction = actions[..., 0]
    norm = actions[..., 1]
    dx = norm * torch.cos(direction)  # (B, T, N, 2)
    dy = norm * torch.sin(direction)
    start = 1 if discard_first_action else 0
    t_idx = torch.arange(actions.shape[1], device=actions.device)
    live = (t_idx >= max(start, 1))[None, :, None, None]
    dx = torch.where(live, dx, torch.zeros_like(dx))
    dy = torch.where(live, dy, torch.zeros_like(dy))
    cx = torch.cumsum(dx, dim=1)
    cy = torch.cumsum(dy, dim=1)
    deltas = torch.stack([cx[..., 0], cy[..., 0], cx[..., 1], cy[..., 1]], dim=-1)
    return initial_bboxes[:, None] + deltas


def reshape_data(tensor: torch.Tensor, track_ids: torch.Tensor) -> torch.Tensor:
    """Scatter (B, T, N, D) rows into the slot their track id gives (-1: null).

    A scatter-add, as in the JAX package: every valid id has one slot in a
    frame (``normalize_track_ids``), and null rows add zeros to slot 0."""
    b, t, n = track_ids.shape
    valid = track_ids >= 0
    safe_ids = torch.where(valid, track_ids, torch.zeros_like(track_ids)).long()
    bi = torch.arange(b, device=tensor.device)[:, None, None].expand(b, t, n)
    ti = torch.arange(t, device=tensor.device)[None, :, None].expand(b, t, n)
    vals = torch.where(valid[..., None], tensor, torch.zeros_like(tensor))
    out = torch.zeros_like(tensor)
    return out.index_put_((bi, ti, safe_ids), vals, accumulate=True)


def normalize_track_ids(track_ids: np.ndarray, max_num_agents: Optional[int] = None) -> np.ndarray:
    """Recast raw track ids to slot ids in [0, N). numpy (host-side).

    Semantics: id 0 in slot 0 is a real id; other zeros are padding (-1).
    First-seen order defines the new index, capped at N unique agents.
    """
    track_ids = np.asarray(track_ids).copy()
    b, t, n = track_ids.shape
    max_num_agents = max_num_agents or n
    first_pos_real = np.zeros_like(track_ids, dtype=bool)
    first_pos_real[:, :, 0] = track_ids[:, :, 0] == 0
    null_mask = (track_ids == 0) & ~first_pos_real
    track_ids[null_mask] = -1

    new_ids = np.full_like(track_ids, -1)
    for bi in range(b):
        uniq = []
        seen = set()
        for val in track_ids[bi].reshape(-1):
            if val != -1 and val not in seen:
                seen.add(val)
                uniq.append(val)
                if len(uniq) >= max_num_agents:
                    break
        mapping = {v: i for i, v in enumerate(uniq)}
        flat = track_ids[bi].reshape(-1)
        out = np.array([mapping.get(v, -1) for v in flat])
        new_ids[bi] = out.reshape(t, n)
    return new_ids


def smooth_gt_leaving_frame(actions: torch.Tensor, bboxes: torch.Tensor) -> torch.Tensor:
    """Repeat the last real action after a bbox collapses to null."""
    null_mask = torch.all(bboxes == 0, dim=-1)  # (B, T, N)
    cumsum = torch.cumsum(null_mask.to(torch.int32), dim=1)
    t_idx = torch.arange(bboxes.shape[1], device=bboxes.device)[None, :, None]
    prev_idx = torch.clamp(t_idx - cumsum, min=0).long()
    index = prev_idx[..., None, None].expand(actions.shape)
    return torch.gather(actions, 1, index)


def process_data(
    cfg, object_data: Dict[str, object], bbox_frame_size=(1382, 512), device=None
) -> Dict[str, Optional[torch.Tensor]]:
    """A batch's objects -> aligned and normalized actions, coords and
    existence, on ``device`` (else ``cfg.device``, else the card)."""
    device = resolve_device(device if device is not None else cfg.device)
    bboxes = torch.as_tensor(object_data["bbox"]).to(device, torch.float32)
    type_ids = torch.as_tensor(object_data["id_type"]).to(device, torch.float32)
    track_ids = np.asarray(torch.as_tensor(object_data["track_id"]).cpu())

    track_ids = torch.from_numpy(normalize_track_ids(track_ids, bboxes.shape[2])).to(device)
    bboxes = reshape_data(bboxes, track_ids)
    type_ids = reshape_data(type_ids[..., None], track_ids)
    existence = bboxes[..., -1:] != 0

    w, h = bbox_frame_size
    scale = torch.tensor([1.0 / w, 1.0 / h, 1.0 / w, 1.0 / h], device=device)
    bboxes = bboxes * scale

    actions, coords = None, None
    if not cfg.pred_coords:
        actions = bbox_seq_to_actions(bboxes)
        if cfg.smooth_gt_leaving_frame:
            actions = smooth_gt_leaving_frame(actions, bboxes)
    else:
        coords = bboxes

    return dict(
        actions=actions,
        coords=coords,
        bboxes=bboxes,
        type_ids=type_ids,
        existence=existence,
    )
