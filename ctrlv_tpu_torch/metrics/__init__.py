"""Metrics of the port: the binary mask IoU that selects the stage-1
candidate, and SSIM and PSNR of the Box2Video evaluation."""

from .image import psnr, ssim
from .iou import binary_mask_iou, binary_mask_iou_batch
