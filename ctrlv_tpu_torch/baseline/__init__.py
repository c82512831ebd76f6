"""The AR bbox baseline (trajeglish style), the stage-1 comparison of the
paper: ``BboxPredictorLM``, its rollout policy, the action vocabulary and
data processing, and the image-context encoder. The commands are
``python -m ctrlv_tpu_torch.tools.train_bbox_baseline`` and
``tools.eval_bbox_baseline``. Counterpart of ``ctrlv_tpu/baseline``."""

from .config import BaselineConfig
from .actions import (
    DIR_DISCRETIZATION,
    NORM_DISCRETIZATION,
    MAX_NORM,
    discretize_actions,
    undiscretize_actions,
    discretize_coords,
    undiscretize_coords,
    bbox_seq_to_actions,
    actions_to_bbox_seq,
    normalize_track_ids,
    reshape_data,
    smooth_gt_leaving_frame,
    process_data,
)
from .model import BboxPredictorLM
from .policy import BboxPredictorLMPolicy
from .image_encoder import ImageEncoder, ImageContextProjector

__all__ = [
    "BaselineConfig",
    "DIR_DISCRETIZATION",
    "NORM_DISCRETIZATION",
    "MAX_NORM",
    "discretize_actions",
    "undiscretize_actions",
    "discretize_coords",
    "undiscretize_coords",
    "bbox_seq_to_actions",
    "actions_to_bbox_seq",
    "normalize_track_ids",
    "reshape_data",
    "smooth_gt_leaving_frame",
    "process_data",
    "BboxPredictorLM",
    "BboxPredictorLMPolicy",
    "ImageEncoder",
    "ImageContextProjector",
]
