"""The one generator of requests, driven by a traffic file's parameters.

A request is a first frame and the bbox frames of its clip: boxes moving
across a dark frame, outlined in their own colours, over a smooth image
(the program's ``tools/bench.py::synthetic_request``, copied and drawn on
the device). Every number of request ``i`` of a run comes from the run's
seed and ``i``: the boxes from a numpy generator, the noises from a
``torch.Generator`` on the device. All requests of a traffic mix have the
same sizes, so that a seed changes what is drawn and never how much work
there is.
"""

from __future__ import annotations

import numpy as np
import torch


def request_seed(seed: int, index: int, stream: int = 0) -> int:
    """A 63-bit seed of request ``index`` of a run (``stream`` tells apart
    the draws of one request)."""
    ss = np.random.SeedSequence([seed % (1 << 64), index, stream])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def bbox_clip(seed: int, index: int, frames: int, height: int, width: int, boxes: int, device):
    """(first frame (1, H, W, 3), bbox frames (1, F, H, W, 3)), both in [-1, 1]."""
    rng = np.random.default_rng(request_seed(seed, index))
    out = torch.full((frames, height, width, 3), -1.0, device=device)
    for _ in range(boxes):
        bw, bh = rng.uniform(width / 12, width / 4), rng.uniform(height / 10, height / 4)
        x0, y0 = rng.uniform(0, width - bw), rng.uniform(0, height - bh)
        dx, dy = rng.uniform(-width, width) / 150, rng.uniform(-height, height) / 150
        colour = torch.tensor(rng.uniform(-0.5, 1.0, size=3), dtype=torch.float32, device=device)
        for f in range(frames):
            x1 = int(np.clip(x0 + dx * f, 0, width - bw - 1))
            y1 = int(np.clip(y0 + dy * f, 0, height - bh - 1))
            x2, y2 = x1 + int(bw), y1 + int(bh)
            out[f, y1:y2, x1:x1 + 2] = colour
            out[f, y1:y2, x2 - 2:x2] = colour
            out[f, y1:y1 + 2, x1:x2] = colour
            out[f, y2 - 2:y2, x1:x2] = colour
    phase = torch.tensor(rng.uniform(0, 2 * np.pi, size=3), dtype=torch.float32, device=device)
    yy = torch.arange(height, dtype=torch.float32, device=device)[:, None, None]
    xx = torch.arange(width, dtype=torch.float32, device=device)[None, :, None]
    image = torch.sin(xx / 37.0 + phase) * torch.cos(yy / 23.0 - phase) * 0.8
    return image[None], out[None]


def noises(seed: int, index: int, batch: int, frames: int, height: int, width: int,
           latent_scale: int, latent_channels: int, device):
    """(image noise (B, H, W, 3), initial latents (B, F, h, w, c)), standard normal."""
    gen = torch.Generator(device=device).manual_seed(request_seed(seed, index, 1))
    image_noise = torch.randn((batch, height, width, 3), generator=gen, device=device)
    latents = torch.randn((batch, frames, height // latent_scale, width // latent_scale,
                           latent_channels), generator=gen, device=device)
    return image_noise, latents


def pick(seed: int, tag: int, population: int, k: int) -> list:
    """``k`` distinct indices below ``population`` drawn from the seed."""
    rng = np.random.default_rng(request_seed(seed, 1 << 20, tag))
    return sorted(int(i) for i in rng.choice(population, size=min(k, population), replace=False))
