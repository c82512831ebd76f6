"""The offline video metrics of an export directory: FVD, SSIM, PSNR, LPIPS.

    python -m ctrlv_tpu_torch.metrics.offline_eval DIR [DIR ...] --device cpu

Counterpart of ``ctrlv_tpu/metrics/offline_eval.py`` (the reference's
``metrics/fvd.py:187-340``): pair ``generated_videos_<i>`` with
``gt_videos_<i>`` by index, take every second frame (``--downsample``, the
default), keep ``--num_frames``, resize to ``--width`` x ``--height``
(bilinear, antialiased, as ``jax.image.resize``), then FVD over all pairs and
the per-pair mean of SSIM (per frame), PSNR and LPIPS. The defaults are the
reference script's: 150 pairs, 11 frames, 410x256.

The weights are state dicts: pytorch-i3d's for the I3D (None: seeded random,
a smoke value), ``lpips.LPIPS(net='alex')``'s for LPIPS (None: the file that
``CTRLV_LPIPS_WEIGHTS`` names, else no LPIPS). The networks and the scores
run on ``device``: None means the card, and raises where there is none.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.resize import resize_bilinear
from ..utils.video_io import load_video
from .common import ieee_f32
from .fvd import FVD
from .image import psnr, ssim
from .lpips import build_lpips, load_lpips_torch_weights, lpips_distance


def pair_video_files(media_dir: str) -> List[Tuple[str, str]]:
    """Match generated_videos_<i> with gt_videos_<i> by shared index."""
    files = os.listdir(media_dir)

    def index_of(name):
        m = re.search(r"_(\d+)\.\w+$", name)
        return m.group(1) if m else None

    gen = {index_of(f): f for f in files if f.startswith("generated_video")}
    gt = {index_of(f): f for f in files if f.startswith("gt_video")}
    return [(os.path.join(media_dir, gen[i]), os.path.join(media_dir, gt[i]))
            for i in sorted(set(gen) & set(gt), key=int)]


def _prepare(video: np.ndarray, size: Tuple[int, int], num_frames: int, downsample: bool,
             device=None) -> torch.Tensor:
    """(F, H, W, 3) uint8 -> (f, size[1], size[0], 3) f32 in [0, 1] on ``device``."""
    v = torch.from_numpy(video).to(device).float() / 255.0
    if downsample:
        v = v[::2]
    return resize_bilinear(v[:num_frames], (size[1], size[0]))


def evaluate_media_dir(
    media_dir: str,
    samples: int = 150,
    num_frames: int = 11,
    downsample: bool = True,
    size: Tuple[int, int] = (410, 256),
    fvd_state_dict: Optional[Dict[str, torch.Tensor]] = None,
    lpips_state_dict: Optional[Dict[str, torch.Tensor]] = None,
    device=None,
) -> Dict[str, float]:
    """{fvd, ssim, psnr, num_pairs[, lpips]} of the first ``samples`` pairs."""
    pairs = pair_video_files(media_dir)[:samples]
    if not pairs:
        raise FileNotFoundError(f"no generated/gt video pairs in {media_dir}")
    fvd = FVD(state_dict=fvd_state_dict, device=device)
    device = fvd.device
    if lpips_state_dict is None:
        weights_path = os.environ.get("CTRLV_LPIPS_WEIGHTS", "")
        if weights_path and os.path.exists(weights_path):
            lpips_state_dict = load_lpips_torch_weights(weights_path)
    lpips = None if lpips_state_dict is None else build_lpips(lpips_state_dict, device)

    ssims, psnrs, lpips_vals = [], [], []
    for gen_path, gt_path in pairs:
        gen = _prepare(load_video(gen_path), size, num_frames, downsample, device)
        gt = _prepare(load_video(gt_path), size, num_frames, downsample, device)
        n = min(len(gen), len(gt))
        gen, gt = gen[:n], gt[:n]
        fvd.update(gt[None], gen[None])
        with ieee_f32():  # SSIM's filter is a convolution
            ssims.append(float(np.mean([float(ssim(gen[i], gt[i])) for i in range(n)])))
        psnrs.append(float(psnr(gen, gt)))
        if lpips is not None:
            lpips_vals.append(float(lpips_distance(lpips, gen * 2.0 - 1.0, gt * 2.0 - 1.0).mean()))

    out = dict(fvd=fvd.compute(), ssim=float(np.mean(ssims)), psnr=float(np.mean(psnrs)),
               num_pairs=len(pairs))
    if lpips_vals:
        out["lpips"] = float(np.mean(lpips_vals))
    return out


def main(argv=None) -> None:
    """The reference's offline harness hardcodes its directories and its
    SAMPLES / NUM_FRAMES / DOWNSAMPLE constants; here they are flags, as in
    the JAX package, plus ``--device``."""
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("media_dirs", nargs="+")
    ap.add_argument("--samples", type=int, default=150)
    ap.add_argument("--num_frames", type=int, default=11)
    ap.add_argument("--downsample", action=argparse.BooleanOptionalAction, default=True,
                    help="2x temporal downsample before scoring (reference default)")
    ap.add_argument("--width", type=int, default=410)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="where the networks run; unset means the card ('cpu' for a CPU run)")
    args = ap.parse_args(argv)
    for d in args.media_dirs:
        print(f"Results for: {d} START -----------------")
        print(json.dumps(evaluate_media_dir(
            d, samples=args.samples, num_frames=args.num_frames, downsample=args.downsample,
            size=(args.width, args.height), device=args.device)))
        print(f"Results for: {d} END   -----------------")


if __name__ == "__main__":
    main()
