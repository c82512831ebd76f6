"""AR rollout policy of the bbox predictor baseline.

Counterpart of ``ctrlv_tpu/baseline/policy.py``: seed the first K frames
(and the last) with the ground-truth action tokens, then sample each later
timestep's tokens with temperature, turn the tokens into box sequences,
render them and score mask IoU (with the first-and-last-frame variant).

As in the JAX policy, each step re-runs the whole decoder over the fixed
(T*N) token grid, the future positions holding placeholder tokens. A step
draws its tokens as ``jax.random.categorical`` does, argmax(logits / temp +
Gumbel noise): from ``gumbel`` where given (one (B, N, 2, V) draw a step,
so a test can inject JAX's draws), else from ``generator`` on the model's
device. Frames are drawn by the native rasterizer, as the port's data path
draws them.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..data.native import rasterize_frame_native
from ..metrics.iou import binary_mask_iou
from ..ops.rasterize import TYPE_COLORS, track_color
from .actions import actions_to_bbox_seq, discretize_actions, undiscretize_actions
from .config import BaselineConfig
from .model import BboxPredictorLM


def sample_gumbel(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(u)) with u uniform in (0, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device).clamp_(min=tiny, max=1.0 - 2**-24)
    return -torch.log(-torch.log(u))


class BboxPredictorLMPolicy:
    def __init__(self, cfg: BaselineConfig, model: BboxPredictorLM):
        self.cfg = cfg
        self.model = model

    @torch.no_grad()
    def rollout(
        self,
        data: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        temperature: Optional[float] = None,
        gumbel: Optional[torch.Tensor] = None,  # (T-K, B, N, 2, V)
    ) -> torch.Tensor:
        """Predicted boxes (B, T, N, 4) in [0, 1] frame coordinates."""
        cfg = self.cfg
        temperature = temperature or cfg.action_temp
        n = cfg.max_num_agents
        bboxes = data["bboxes"][:, :, :n]
        b, t = bboxes.shape[:2]
        k = cfg.initial_frames_condition_num

        gt_tokens = discretize_actions(
            data["actions"][:, :, :n], cfg.dir_disc, cfg.norm_disc).to(torch.int32)
        tokens = torch.zeros_like(gt_tokens)
        tokens[:, :k] = gt_tokens[:, :k]
        if cfg.condition_last_frame:
            tokens[:, -1] = gt_tokens[:, -1]

        for step in range(k, t):
            preds = self.model(data, actions_override=tokens)["action_preds"]  # (B,T,N,2,V)
            logits = preds[:, step - 1].float() / temperature
            g = (gumbel[step - k].to(logits.device) if gumbel is not None
                 else sample_gumbel(logits.shape, generator, logits.device))
            tokens[:, step] = torch.argmax(logits + g, dim=-1).to(torch.int32)

        actions = undiscretize_actions(tokens, cfg.dir_disc, cfg.norm_disc)
        # the seeded frames keep their ground-truth actions exactly
        gt_actions = data["actions"][:, :, :n]
        actions = torch.cat([gt_actions[:, :k], actions[:, k:]], dim=1)
        pred_bboxes = actions_to_bbox_seq(actions, bboxes[:, 0])
        # agents absent at t=0 stay absent
        exist0 = data["existence"][:, 0:1, :n].to(pred_bboxes.dtype)
        return pred_bboxes * exist0

    # ------------------------------------------------------------------
    def render(self, pred_bboxes: np.ndarray, type_ids: np.ndarray) -> np.ndarray:
        """(T, N, 4) normalized boxes -> (T, H, W, 3) rendered frames in [0, 1]."""
        cfg = self.cfg
        pred_bboxes, type_ids = np.asarray(pred_bboxes), np.asarray(type_ids)
        scale = np.asarray([cfg.train_W, cfg.train_H, cfg.train_W, cfg.train_H])
        n = pred_bboxes.shape[1]
        kcol = track_color(np.arange(n))
        corners = np.full((n, 8, 2), -1e4, np.float32)
        frames = []
        for tstep in range(pred_bboxes.shape[0]):
            boxes = pred_bboxes[tstep] * scale
            valid = pred_bboxes[tstep].sum(axis=-1) != 0
            # the JAX rasterizer indexes the colours by box, so only the first
            # n of the frame's (up to 30) types are read
            tcol = TYPE_COLORS[
                np.clip(type_ids[tstep].astype(int).reshape(-1)[:n], 0, len(TYPE_COLORS) - 1)]
            frames.append(rasterize_frame_native(corners, boxes, valid, tcol, kcol,
                                                 height=cfg.train_H, width=cfg.train_W))
        return np.stack(frames)

    def score(self, pred_frames: np.ndarray, gt_frames: np.ndarray) -> Dict[str, float]:
        miou, ap, ar = binary_mask_iou(gt_frames, pred_frames)
        fl = [0, len(gt_frames) - 1]
        miou_fl, ap_fl, ar_fl = binary_mask_iou(gt_frames[fl], pred_frames[fl])
        return dict(
            miou=miou, ap=ap, ar=ar,
            miou_first_last=miou_fl, ap_first_last=ap_fl, ar_first_last=ar_fl,
        )
