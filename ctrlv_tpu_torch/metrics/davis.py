"""DAVIS semi-supervised evaluation over the port's ``fandj``.

The port's copy of ``ctrlv_tpu/metrics/davis.py`` (the reference's
``DAVISEvaluation._evaluate_semisupervised``, ``metrics/FandJ.py:25-41``):
per-object J (region) and F (boundary) over (num_objects, F, H, W) mask
stacks, the result zero-padded where it has fewer objects than the ground
truth.
"""

from __future__ import annotations

import numpy as np

from .fandj import db_eval_boundary, db_eval_iou


class DAVISEvaluation:
    @staticmethod
    def evaluate_semisupervised(
        all_gt_masks: np.ndarray,  # (num_objects, F, H, W)
        all_res_masks: np.ndarray,
        all_void_masks=None,
        metric=("J", "F"),
    ):
        if all_res_masks.shape[0] > all_gt_masks.shape[0]:
            raise ValueError(
                "result masks contain more object indices than the ground truth"
            )
        if all_res_masks.shape[0] < all_gt_masks.shape[0]:
            pad = np.zeros(
                (all_gt_masks.shape[0] - all_res_masks.shape[0],)
                + all_res_masks.shape[1:]
            )
            all_res_masks = np.concatenate([all_res_masks, pad], axis=0)
        num_objects, num_frames = all_gt_masks.shape[:2]
        j = np.zeros((num_objects, num_frames))
        f = np.zeros((num_objects, num_frames))
        for i in range(num_objects):
            if "J" in metric:
                j[i] = db_eval_iou(all_gt_masks[i], all_res_masks[i], all_void_masks)
            if "F" in metric:
                f[i] = db_eval_boundary(all_gt_masks[i], all_res_masks[i], all_void_masks)
        return j, f
