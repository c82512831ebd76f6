"""Evaluate the AR bbox-predictor baseline by rollout and mask IoU.

    python -m ctrlv_tpu_torch.tools.eval_bbox_baseline key=value ...

Counterpart of ``tools/eval_bbox_baseline.py``: the parameters of the
latest checkpoint under ``output/baseline_checkpoints`` (the fresh seeded
init where there is none, as the JAX tool falls back to its init), then for
``num_samples`` clips of the validation loader a temperature-sampled rollout
seeded with the conditioning frames, the prediction and the ground truth
rendered, scored (mask IoU, precision, recall, and the same over the first
and last frames) and the prediction exported as
``output/baseline_eval/rollout_{i}.gif``; the summary is the mean of each
score. Runs on the card unless ``device=cpu``.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from typing import Optional, Sequence

import numpy as np
import torch

from ..baseline import BaselineConfig, BboxPredictorLMPolicy, process_data
from ..baseline.config import config_from_overrides
from ..data import get_dataloader
from ..pipelines.common import resolve_device
from ..train.checkpoints import CheckpointManager
from ..utils.video_io import export_to_video, frames_to_uint8
from .train_bbox_baseline import CHECKPOINT_DIR, build_model

OUT_DIR = os.path.join("output", "baseline_eval")


def main(cfg: Optional[BaselineConfig] = None, num_samples=4, model=None, dataset_name=None,
         gumbel: Optional[Sequence[torch.Tensor]] = None, history: Optional[list] = None):
    """The summary of the scores. ``gumbel[i]``, where given, holds sample
    i's Gumbel draws (``BboxPredictorLMPolicy.rollout``); else they come from
    a generator seeded with ``cfg.seed``. ``history``, where given, receives
    one dict a sample: its scores, the seconds of its rollout, render and
    export, and its count of frames."""
    cfg = cfg or BaselineConfig()
    dataset_name = dataset_name or cfg.dataset
    device = resolve_device(cfg.device)
    dataset, loader = get_dataloader(
        cfg.data_root, dataset_name, if_train=False, batch_size=1,
        clip_length=cfg.num_timesteps, shuffle=False,
        train_H=cfg.train_H, train_W=cfg.train_W,
    )
    frame_size = (dataset.orig_W, dataset.orig_H)
    if model is None:
        model = build_model(cfg, device)
        restored = CheckpointManager(CHECKPOINT_DIR).restore(template=model.state_dict())
        if restored is not None:
            model.load_state_dict(restored, strict=True)
    model.eval()

    policy = BboxPredictorLMPolicy(cfg, model)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    scores = defaultdict(list)
    os.makedirs(OUT_DIR, exist_ok=True)
    for i, batch in enumerate(iter(loader)):
        if i >= num_samples:
            break
        data = process_data(cfg, batch["objects"], frame_size, device)
        t0 = time.perf_counter()
        pred = policy.rollout(data, generator, gumbel=None if gumbel is None else gumbel[i])
        pred0 = pred[0].cpu().numpy()
        t1 = time.perf_counter()
        type_ids = data["type_ids"][0].cpu().numpy()
        pred_frames = policy.render(pred0, type_ids)
        gt_frames = policy.render(data["bboxes"][0].cpu().numpy(), type_ids)
        t2 = time.perf_counter()
        s = policy.score(pred_frames, gt_frames)
        for k, v in s.items():
            scores[k].append(v)
        print(f"[{i}] miou={s['miou']:.3f} avg={np.mean(scores['miou']):.3f}", flush=True)
        export_to_video(frames_to_uint8(pred_frames), os.path.join(OUT_DIR, f"rollout_{i}.gif"),
                        fps=cfg.video_fps)
        if history is not None:
            history.append(dict(s, rollout_s=t1 - t0, render_s=t2 - t1,
                                export_s=time.perf_counter() - t2, frames=len(pred_frames)))
    summary = {k: float(np.mean(v)) for k, v in scores.items()}
    print("summary:", summary, flush=True)
    return summary


if __name__ == "__main__":
    main(cfg=config_from_overrides())
