"""Metrics of the port: the binary mask IoU that selects the stage-1 candidate."""

from .iou import binary_mask_iou, binary_mask_iou_batch
