"""Fourier embeddings of bounding-box object attributes, in torch.

The port's copy of ``ctrlv_tpu/utils/fourier.py`` (the reference's
``utils/util.py:177-239``): an object's token is sin/cos(100^(k/8) * attrs)
over its 13 scalar box attributes (truncated, alpha, the 4 bbox coordinates
rescaled to [0, 1], 3 dimensions, 3 locations, rotation_y), its 4-bit binary
track id L2-normalised, the frame's index over the clip length and its 4-bit
binary type id; zero beyond ``num_objects``; dropout drops whole objects.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def rescale_bbox(bbox, image_size=(1242, 375), target_size=(1, 1)) -> torch.Tensor:
    """(..., 4) xyxy boxes from one pixel space to another."""
    bbox = torch.as_tensor(bbox)
    sx = target_size[0] / image_size[0]
    sy = target_size[1] / image_size[1]
    scale = torch.tensor([sx, sy, sx, sy], dtype=bbox.dtype, device=bbox.device)
    return bbox * scale


def to_binary(x, bits: int = 4) -> torch.Tensor:
    """Integers -> (..., bits) booleans, least significant bit first."""
    x = torch.as_tensor(x)
    mask = 2 ** torch.arange(bits, device=x.device)
    return (x[..., None] & mask) != 0


class FourierEmbedder:
    """sin/cos features at ``num_freqs`` geometric frequencies
    (temperature^(k/num_freqs))."""

    def __init__(self, num_freqs: int = 64, temperature: float = 100.0):
        self.num_freqs = num_freqs
        self.freq_bands = temperature ** (torch.arange(num_freqs) / num_freqs)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        temp = x[..., None] * self.freq_bands.to(x.device, x.dtype)
        return torch.cat([torch.sin(temp), torch.cos(temp)], dim=-1)


def get_fourier_embeds_from_boundingbox(
    objects: Dict[str, torch.Tensor],
    image_size: Tuple[int, int] = (1242, 375),
    dropout_prob: float = 0.0,
    generator: Optional[torch.Generator] = None,
    embed_dim: int = 8,
    bits: int = 4,
) -> torch.Tensor:
    """Object dicts -> (B, F, N, embed_dim*2*(13+2*bits+1)) tokens.

    objects' keys, each (B, F, N, ...): bbox, truncated, alpha, dimensions,
    locations, rotation_y, track_id, id_type; num_objects (B,) or (B, F).
    Dropout draws from ``generator`` where ``dropout_prob`` > 0 and one is
    given, as the JAX function draws from its key."""
    objects = {k: torch.as_tensor(v) for k, v in objects.items()}
    bbox = rescale_bbox(objects["bbox"], image_size, (1, 1))
    feats = torch.cat(
        [
            objects["truncated"][..., None],
            objects["alpha"][..., None],
            bbox,
            objects["dimensions"],
            objects["locations"],
            objects["rotation_y"][..., None],
        ],
        dim=-1,
    )  # (B, F, N, 13)
    b, f, n = feats.shape[:3]

    def l2norm(x):
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)

    object_ids = l2norm(to_binary(objects["track_id"], bits).to(feats.dtype))
    type_ids = l2norm(to_binary(objects["id_type"], bits).to(feats.dtype))
    frame_ids = (torch.arange(f, dtype=feats.dtype, device=feats.device) / f)[
        None, :, None, None].expand(b, f, n, 1)
    tokens = torch.cat([feats, object_ids, frame_ids, type_ids], dim=-1)

    freqs = 100.0 ** (torch.arange(embed_dim, dtype=feats.dtype, device=feats.device) / embed_dim)
    ang = tokens[..., None] * freqs  # (B, F, N, D, E)
    emb = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)  # (B, F, N, D, E, 2)
    # the reference's layout: the feature dimension last-major
    emb = emb.permute(0, 1, 2, 4, 5, 3).reshape(b, f, n, -1)

    num_objects = objects["num_objects"].to(feats.device)
    if num_objects.ndim == 1:
        num_objects = num_objects[:, None]
    slot = torch.arange(n, device=feats.device)[None, None, :]
    valid = slot < num_objects[..., None]
    emb = torch.where(valid[..., None], emb, torch.zeros((), dtype=emb.dtype, device=emb.device))

    if dropout_prob > 0.0 and generator is not None:
        keep = torch.rand((b, f, n, 1), generator=generator, device=generator.device) >= dropout_prob
        emb = torch.where(keep.to(emb.device), emb, torch.zeros((), dtype=emb.dtype,
                                                                device=emb.device))
    return emb
