"""Object padding and batch collation of the port's data path.

Counterpart of ``ctrlv_tpu/data/collate.py`` (the reference's
``datasets/__init__.py:8-151``): every frame's objects go into
MAX_BOXES_PER_DATA = 30 zero-padded slots, and a batch is a dict of dense
arrays (B, F, 30, ...). ``objects_to_arrays`` and ``init_objects`` are the
JAX package's numpy, unchanged; ``collate_clip_batch`` returns torch tensors
(which a ``DataLoader`` can pin), equal to the JAX package's arrays.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

MAX_BOXES_PER_DATA = 30

COCO_LABELS_LOOKUP = {
    0: "person",
    1: "bicycle",
    2: "car",
    3: "motorcycle",
    4: "airplane",
    5: "bus",
    6: "train",
    7: "truck",
    8: "boat",
    9: "traffic light",
    10: "fire hydrant",
    11: "street sign",
    12: "stop sign",
    13: "parking meter",
    14: "bench",
}


def init_objects(len_target: int = 0) -> Dict[str, np.ndarray]:
    """One frame's zero-padded object dict (30 slots)."""
    n = MAX_BOXES_PER_DATA
    return dict(
        type=[None] * n,
        truncated=np.zeros(n, np.float32),
        occluded=np.zeros(n, np.int64),
        alpha=np.zeros(n, np.float32),
        bbox=np.zeros((n, 4), np.float32),
        dimensions=np.zeros((n, 3), np.float32),
        locations=np.zeros((n, 3), np.float32),
        rotation_y=np.zeros(n, np.float32),
        id_type=np.zeros(n, np.int64),
        track_id=np.zeros(n, np.int64),
        num_objects=min(len_target, n),
    )


def objects_to_arrays(frame_labels: Sequence[Optional[list]]) -> Dict[str, np.ndarray]:
    """List of per-frame label lists -> stacked (F, 30, ...) arrays."""
    frames = []
    for labels in frame_labels:
        objs = init_objects(len(labels) if labels is not None else 0)
        if labels is not None:
            for i in range(objs["num_objects"]):
                lab = labels[i]
                objs["type"][i] = lab.get("type")
                objs["truncated"][i] = lab.get("truncated", 0.0)
                objs["occluded"][i] = lab.get("occluded", 0)
                objs["alpha"][i] = lab.get("alpha", 0.0)
                objs["bbox"][i] = np.asarray(lab["bbox"], np.float32)
                objs["dimensions"][i] = np.asarray(
                    lab.get("dimensions", (0, 0, 0)), np.float32
                )
                objs["locations"][i] = np.asarray(
                    lab.get("location", (0, 0, 0)), np.float32
                )
                objs["rotation_y"][i] = lab.get("rotation_y", 0.0)
                objs["id_type"][i] = lab.get("id_type", 0)
                objs["track_id"][i] = lab.get("trackID", 0)
        frames.append(objs)

    out: Dict[str, np.ndarray] = {}
    for key in frames[0]:
        if key == "type":
            continue
        if key == "num_objects":
            out[key] = np.asarray([f[key] for f in frames], np.int64)
        else:
            out[key] = np.stack([f[key] for f in frames])
    return out


def collate_clip_batch(samples: List[dict]) -> Dict[str, object]:
    """Dataset samples -> a batch: ``clips`` (B, F, H, W, 3) float32,
    ``bbox_images`` likewise where the samples have them, ``objects`` a dict
    of (B, F, 30, ...) tensors, ``cam_to_img`` (B, 3, 4) where the samples
    have a calibration, and the lists ``indices`` and ``prompts``."""
    batch: Dict[str, object] = {
        "clips": (torch.from_numpy(np.stack([s["clip"] for s in samples]))
                  if samples[0].get("clip") is not None else None),
        "indices": [s["index"] for s in samples],
        "prompts": [s.get("prompt", "") for s in samples],
    }
    objs = [objects_to_arrays(s["labels"]) for s in samples]
    batch["objects"] = {k: torch.from_numpy(np.stack([o[k] for o in objs])) for k in objs[0]}
    if samples[0].get("bbox_images") is not None:
        batch["bbox_images"] = torch.from_numpy(np.stack([s["bbox_images"] for s in samples]))
    if samples[0].get("cam_to_img") is not None:
        batch["cam_to_img"] = torch.from_numpy(
            np.stack([np.asarray(s["cam_to_img"], np.float32) for s in samples]))
    return batch
