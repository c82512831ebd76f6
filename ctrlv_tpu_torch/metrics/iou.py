"""Binary mask IoU, precision and recall: the stage-1 selection metric.

Counterpart of ``ctrlv_tpu/metrics/iou.py``. A mask is "any channel
non-zero" (the channel sum as a boolean) over a whole clip; an empty union,
ground truth or prediction scores 1. ``binary_mask_iou`` is numpy;
``binary_mask_iou_batch`` works on tensors, so that the overall pipeline
selects among its candidates on the device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def binary_mask_iou(image_gt, image_pred, channel_axis: int = -1) -> Tuple[float, float, float]:
    """(iou, precision, recall) over channel-summed binary masks, any layout;
    ``channel_axis`` names the channel axis."""
    gt = np.asarray(image_gt).sum(axis=channel_axis).astype(bool)
    pred = np.asarray(image_pred).sum(axis=channel_axis).astype(bool)
    gt_area = gt.sum()
    pred_area = pred.sum()
    inter = np.logical_and(gt, pred).sum()
    union = gt_area + pred_area - inter
    iou = inter / union if union > 0 else 1.0
    recall = inter / gt_area if gt_area > 0 else 1.0
    precision = inter / pred_area if pred_area > 0 else 1.0
    return float(iou), float(precision), float(recall)


def binary_mask_iou_batch(gt, pred):
    """(iou, precision, recall) rows for stacked candidates.

    gt: (F, H, W, C) ground-truth clip; pred: (N, F, H, W, C) candidates;
    both non-negative. Returns an (N, 3) f32 tensor on pred's device.
    """
    gt_mask = (gt.sum(dim=-1) > 0).float()  # (F, H, W)
    pred_mask = (pred.sum(dim=-1) > 0).float()  # (N, F, H, W)
    axes = tuple(range(1, pred_mask.dim()))
    inter = (gt_mask[None] * pred_mask).sum(dim=axes)
    gt_area = gt_mask.sum().expand_as(inter)
    pred_area = pred_mask.sum(dim=axes)
    union = gt_area + pred_area - inter
    one = torch.ones_like(inter)
    iou = torch.where(union > 0, inter / union, one)
    precision = torch.where(pred_area > 0, inter / pred_area, one)
    recall = torch.where(gt_area > 0, inter / gt_area, one)
    return torch.stack([iou, precision, recall], dim=-1)
