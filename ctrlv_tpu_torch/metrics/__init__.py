"""Metrics of the port: the binary mask IoU that selects the stage-1
candidate, DAVIS J&F and the stage-1 eval's boundary F, SSIM and PSNR, LPIPS,
and (in ``metrics.fvd`` and ``metrics.offline_eval``) FVD and the offline
eval of an export directory.

The names of ``ctrlv_tpu/metrics/__init__.py``, under the port's types:
``lpips_init_params`` and ``load_lpips_torch_weights`` give state dicts,
which ``LPIPS`` loads as they are (strictly), so the JAX package's
``lpips_torch_to_flax`` has no counterpart here; its inverse,
``convert.lpips_flax_to_state_dict``, carries JAX params across.
"""

from .davis import DAVISEvaluation
from .fandj import db_eval_boundary, db_eval_iou, f_measure, pil_luma_uint8, stage1_frame_f_measure
from .image import psnr, ssim
from .iou import binary_mask_iou, binary_mask_iou_batch
from .lpips import LPIPS, load_lpips_torch_weights, lpips_distance, lpips_init_params

__all__ = [
    "binary_mask_iou",
    "binary_mask_iou_batch",
    "db_eval_iou",
    "db_eval_boundary",
    "f_measure",
    "pil_luma_uint8",
    "stage1_frame_f_measure",
    "ssim",
    "psnr",
    "DAVISEvaluation",
    "LPIPS",
    "lpips_distance",
    "lpips_init_params",
    "load_lpips_torch_weights",
]
