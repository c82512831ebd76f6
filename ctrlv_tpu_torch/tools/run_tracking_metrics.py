"""Detection mAP of generated videos against their ground-truth videos.

    python -m ctrlv_tpu_torch.tools.run_tracking_metrics --eval_dir DIR [--device cpu]

Counterpart of ``tools/run_tracking_metrics.py`` (the reference's tool of the
same name), its arithmetic copied in numpy, bit-equal to the JAX tool's:
detect objects in each frame (YOLOv8x, confidence 0.10, IoU 0.35), keep
boxes at least 8 % of the frame wide or high (:156-163), match the
detections of the generated video to those of the ground truth at IoU
thresholds 0.50:0.05:0.95 (:174-179), AP from the recall/precision pairs of
a confidence sweep 0:0.01:1 (:212-253).

The detector is the ``ultralytics`` package with its ``yolov8x.pt`` weights,
which are not part of this repository. ``get_detector`` returns None
without the package, as the JAX tool's does, and ``main`` then says so and
stops; ``evaluate_video_pair`` takes detections from any source. The
detector runs on the card unless ``--device`` says otherwise.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from ..pipelines.common import resolve_device

IOU_THRESHOLDS = np.arange(0.5, 0.96, 0.05)
CONF_SWEEP = np.arange(0.0, 1.001, 0.01)
MIN_BOX_FRACTION = 0.08


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU matrix between (N,4) and (M,4) xyxy boxes."""
    area_a = (a[:, 2] - a[:, 0]).clip(0) * (a[:, 3] - a[:, 1]).clip(0)
    area_b = (b[:, 2] - b[:, 0]).clip(0) * (b[:, 3] - b[:, 1]).clip(0)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clip(0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None] - inter
    return inter / np.maximum(union, 1e-9)


def filter_small_boxes(boxes: np.ndarray, frame_hw, min_fraction=MIN_BOX_FRACTION):
    """Keep boxes whose width or height >= min_fraction of the frame."""
    if len(boxes) == 0:
        return boxes
    h, w = frame_hw
    bw = boxes[:, 2] - boxes[:, 0]
    bh = boxes[:, 3] - boxes[:, 1]
    keep = (bw >= min_fraction * w) | (bh >= min_fraction * h)
    return boxes[keep]


def match_frame(
    pred_boxes: np.ndarray,  # (N, 5): xyxy + conf
    gt_boxes: np.ndarray,  # (M, 4)
    iou_thresholds: np.ndarray = IOU_THRESHOLDS,
) -> np.ndarray:
    """(N, len(thresholds)) bool: prediction matched at each IoU level."""
    n = len(pred_boxes)
    correct = np.zeros((n, len(iou_thresholds)), bool)
    if n == 0 or len(gt_boxes) == 0:
        return correct
    iou = box_iou(pred_boxes[:, :4], gt_boxes)
    for ti, thr in enumerate(iou_thresholds):
        # greedy one-to-one matching by IoU, highest-conf predictions first
        order = np.argsort(-pred_boxes[:, 4])
        taken = np.zeros(len(gt_boxes), bool)
        for pi in order:
            gi = np.argmax(np.where(taken, -1.0, iou[pi]))
            if iou[pi, gi] >= thr and not taken[gi]:
                correct[pi, ti] = True
                taken[gi] = True
    return correct


def average_precision(
    all_correct: np.ndarray,  # (N, T) matches
    all_conf: np.ndarray,  # (N,)
    num_gt: int,
    conf_sweep: np.ndarray = CONF_SWEEP,
) -> np.ndarray:
    """AP per IoU threshold from the recall/precision confidence sweep."""
    aps = []
    for ti in range(all_correct.shape[1]):
        recalls, precisions = [], []
        for conf in conf_sweep:
            keep = all_conf >= conf
            tp = all_correct[keep, ti].sum()
            fp = keep.sum() - tp
            recalls.append(tp / max(num_gt, 1))
            precisions.append(tp / max(tp + fp, 1))
        recalls = np.asarray(recalls)
        precisions = np.asarray(precisions)
        # integrate PR (sort by recall, trapezoid with monotone precision)
        order = np.argsort(recalls)
        r, p = recalls[order], precisions[order]
        p = np.maximum.accumulate(p[::-1])[::-1]
        aps.append(float(np.trapezoid(p, r)))
    return np.asarray(aps)


def evaluate_video_pair(
    gen_detections: Sequence[np.ndarray],  # per-frame (N, 5) xyxy+conf
    gt_detections: Sequence[np.ndarray],  # per-frame (M, 4) or (M, 5)
    frame_hw,
) -> Dict[str, float]:
    corrects, confs, num_gt = [], [], 0
    for gen, gt in zip(gen_detections, gt_detections):
        gt = np.asarray(gt)[:, :4] if len(gt) else np.zeros((0, 4))
        gt = filter_small_boxes(gt, frame_hw)
        gen = np.asarray(gen) if len(gen) else np.zeros((0, 5))
        if gen.size:
            keep = filter_small_boxes(gen[:, :4], frame_hw)
            # re-filter with conf attached
            mask = np.isin(gen[:, :4], keep).all(axis=1) if len(keep) else np.zeros(len(gen), bool)
            gen = gen[mask]
        num_gt += len(gt)
        corrects.append(match_frame(gen, gt))
        confs.append(gen[:, 4] if gen.size else np.zeros((0,)))
    all_correct = np.concatenate(corrects) if corrects else np.zeros((0, len(IOU_THRESHOLDS)))
    all_conf = np.concatenate(confs) if confs else np.zeros((0,))
    aps = average_precision(all_correct, all_conf, num_gt)
    return {
        "mAP50-95": float(aps.mean()),
        "AP50": float(aps[0]),
        "AP75": float(aps[5]),
        "num_gt": num_gt,
    }


def get_detector(device=None) -> Optional[Callable]:
    """A frame -> (N, 5) xyxy + confidence callable on ``device``, or None
    where the ``ultralytics`` package is absent."""
    try:
        from ultralytics import YOLO  # optional binary dependency
    except ImportError:
        return None
    model = YOLO("yolov8x.pt")

    def detect(frame: np.ndarray) -> np.ndarray:
        res = model(frame, conf=0.10, iou=0.35, verbose=False, device=device)[0]
        boxes = res.boxes.xyxy.cpu().numpy()
        conf = res.boxes.conf.cpu().numpy()[:, None]
        return np.concatenate([boxes, conf], axis=1)

    return detect


def main(cfg=None):
    from ..utils.config import parse_args
    from ..utils.video_io import load_video

    cfg = cfg or parse_args()
    device = resolve_device(cfg.device)
    detect = get_detector(str(device))
    if detect is None:
        print(
            "ultralytics not installed — run with cached detections via "
            "evaluate_video_pair(), or install the detector offline."
        )
        return None
    eval_dir = cfg.eval_dir or cfg.output_dir
    gen_files = sorted(f for f in os.listdir(eval_dir) if f.startswith("generated_video"))
    results = []
    for f in gen_files:
        gen = load_video(os.path.join(eval_dir, f))
        gt = load_video(os.path.join(eval_dir, f.replace("generated", "gt")))
        gen_det = [detect(fr) for fr in gen]
        gt_det = [detect(fr) for fr in gt]
        results.append(evaluate_video_pair(gen_det, gt_det, gen.shape[1:3]))
        print(f, results[-1])
    print("mean mAP50-95:", np.mean([r["mAP50-95"] for r in results]))
    return results


if __name__ == "__main__":
    main()
