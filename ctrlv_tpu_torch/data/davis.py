"""DAVIS video object segmentation, its boxes taken from the masks.

The port's copy of ``ctrlv_tpu/data/davis.py`` (the reference's
``datasets/davis.py``): frames under ``JPEGImages/480p/<seq>``, indexed-PNG
masks under ``Annotations/480p/<seq>``, each object's 2D box the extent of
its mask (``masks_to_boxes``), the split from ``ImageSets/2017/{train,
val}.txt`` (every sequence where it is absent).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List

import numpy as np

from .base import VideoDataset


def masks_to_boxes(mask: np.ndarray) -> dict:
    """Indexed mask (H,W) -> {object_id: [x1,y1,x2,y2]}."""
    boxes = {}
    for obj_id in np.unique(mask):
        if obj_id == 0:
            continue
        ys, xs = np.nonzero(mask == obj_id)
        boxes[int(obj_id)] = [
            float(xs.min()), float(ys.min()), float(xs.max()), float(ys.max())
        ]
    return boxes


@dataclasses.dataclass
class DAVISDataset(VideoDataset):
    version: str = "DAVIS"
    resolution: str = "480p"
    max_boxes: int = 30

    def __post_init__(self):
        self.orig_H, self.orig_W = 480, 854
        split_file = os.path.join(
            self.root, self.version, "ImageSets", "2017",
            "train.txt" if self.train else "val.txt",
        )
        if os.path.exists(split_file):
            with open(split_file) as f:
                seqs = [line.strip() for line in f if line.strip()]
        else:
            img_root = os.path.join(self.root, self.version, "JPEGImages", self.resolution)
            seqs = sorted(os.listdir(img_root)) if os.path.isdir(img_root) else []

        self.image_list: List[str] = []
        self.clip_list: List[List[int]] = []
        for seq in seqs:
            seq_dir = os.path.join(
                self.root, self.version, "JPEGImages", self.resolution, seq
            )
            if not os.path.isdir(seq_dir):
                continue
            idxs = []
            for f in sorted(os.listdir(seq_dir)):
                self.image_list.append(os.path.join(seq_dir, f))
                idxs.append(len(self.image_list) - 1)
            if self.data_type == "clip":
                if self.non_overlapping_clips:
                    for ci in range(len(idxs) // self.clip_length):
                        self.clip_list.append(
                            idxs[ci * self.clip_length : (ci + 1) * self.clip_length]
                        )
                else:
                    for i in range(len(idxs) - self.clip_length + 1):
                        self.clip_list.append(idxs[i : i + self.clip_length])

    def __len__(self):
        return len(self.image_list) if self.data_type == "image" else len(self.clip_list)

    def num_frames_total(self):
        return len(self.image_list)

    def _frame_global_index(self, index, offset):
        return index if self.data_type == "image" else self.clip_list[index][offset]

    def get_frame_file_by_index(self, index, offset=0):
        return self.image_list[self._frame_global_index(index, offset)]

    def get_labels_by_index(self, index, offset=0) -> List[dict]:
        from PIL import Image

        path = self.get_frame_file_by_index(index, offset)
        mask_path = (
            path.replace("JPEGImages", "Annotations").rsplit(".", 1)[0] + ".png"
        )
        if not os.path.exists(mask_path):
            return []
        mask = np.asarray(Image.open(mask_path))
        labels = []
        for obj_id, box in masks_to_boxes(mask).items():
            labels.append(
                dict(
                    frame=os.path.basename(path),
                    trackID=obj_id,
                    type="object",
                    truncated=0.0,
                    occluded=0,
                    alpha=0.0,
                    bbox=box,
                    dimensions=[0.0, 0.0, 0.0],
                    location=[0.0, 0.0, 0.0],
                    rotation_y=0.0,
                    id_type=obj_id % 10,
                )
            )
            if len(labels) >= self.max_boxes:
                break
        return labels

    def get_calib_by_index(self, index):
        return None

    def get_prompt(self, index):
        return "A video of moving objects."
