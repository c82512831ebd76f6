"""KITTI tracking dataset.

The port's copy of ``ctrlv_tpu/data/kitti.py`` (the reference's
``datasets/kitti.py``): scenes 0000-0018 train, 0019-0020 test; per-scene
``label_02/<scene>.txt`` rows (frame trackID type truncated occluded alpha
bbox4 dims3 loc3 rot_y), DontCare dropped, 30-box cap; the calibration's P2
row; preplotted bbox frames under ``bbox_02``; a fixed prompt.

Each scene's label file is read once and its frames cached. The JAX package
reads it with pandas; this reads the space-separated rows itself (pandas is
no dependency of the port), giving the same labels.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np

from .base import VideoDataset

IDS_CLASS_LOOKUP = {
    1: "Car", 2: "Van", 3: "Truck", 4: "Pedestrian", 5: "Person",
    6: "Cyclist", 7: "Tram", 8: "Misc", 9: "DontCare",
}
CLASS_IDS_LOOKUP = {v: k for k, v in IDS_CLASS_LOOKUP.items()}
TO_COCO_LABELS = {1: 2, 2: 2, 3: 7, 4: 0, 5: 0, 6: 1, 7: 6, 8: 14}


def parse_label_file(path: str, max_boxes: int = 30) -> Dict[int, list]:
    """A KITTI tracking label file -> {frame: [label dict, ...]}, frames in
    ascending order, rows in file order, DontCare dropped, at most
    ``max_boxes`` a frame."""
    rows: Dict[int, list] = {}
    with open(path) as f:
        for line in f:
            p = line.strip().split(" ")
            if p == [""]:
                continue
            if len(p) != 17:
                raise ValueError(f"{path}: a label row has {len(p)} fields, expected 17: {line!r}")
            if p[2] == "DontCare":
                continue
            v = [float(x) for x in p[3:]]
            frame = int(p[0])
            rows.setdefault(frame, []).append(
                dict(
                    frame=frame,
                    trackID=int(p[1]),
                    type=p[2],
                    truncated=v[0],
                    occluded=int(v[1]),
                    alpha=v[2],
                    bbox=v[3:7],
                    dimensions=v[7:10],
                    location=v[10:13],
                    rotation_y=v[13],
                    id_type=CLASS_IDS_LOOKUP.get(p[2], 8),
                )
            )
    return {frame: rows[frame][:max_boxes] for frame in sorted(rows)}


@dataclasses.dataclass
class KittiDataset(VideoDataset):
    version: str = "kitti"
    max_boxes: int = 30

    TO_IMAGE_DIR = "image_02"
    TO_LABEL_DIR = "label_02"
    TO_BBOX_DIR = "bbox_02"
    TRAIN_SPLIT = tuple(f"{i:04d}" for i in range(19))
    TEST_SPLIT = ("0019", "0020")

    def __post_init__(self):
        self._location = "training"
        image_dir = os.path.join(self.root, self.version, self._location, self.TO_IMAGE_DIR)
        split = self.TRAIN_SPLIT if self.train else self.TEST_SPLIT
        self.image_list: List[str] = []
        self.scene_of_frame: List[str] = []
        self.clip_list: List[List[int]] = []
        for scene in split:
            scene_dir = os.path.join(image_dir, scene)
            if not os.path.isdir(scene_dir):
                continue
            idxs = []
            for f in sorted(os.listdir(scene_dir)):
                self.image_list.append(os.path.join(scene_dir, f))
                self.scene_of_frame.append(scene)
                idxs.append(len(self.image_list) - 1)
            if self.data_type == "clip":
                if self.non_overlapping_clips:
                    for ci in range(len(idxs) // self.clip_length):
                        self.clip_list.append(
                            idxs[ci * self.clip_length : (ci + 1) * self.clip_length]
                        )
                else:
                    for i in range(len(idxs) - self.clip_length):
                        self.clip_list.append(idxs[i : i + self.clip_length])

    def __len__(self) -> int:
        return len(self.image_list) if self.data_type == "image" else len(self.clip_list)

    def num_frames_total(self) -> int:
        return len(self.image_list)

    # ------------------------------------------------------------------
    def _frame_global_index(self, index: int, offset: int) -> int:
        if self.data_type == "image":
            return index
        return self.clip_list[index][offset]

    def get_frame_file_by_index(self, index: int, offset: int = 0) -> str:
        return self.image_list[self._frame_global_index(index, offset)]

    def _scene_labels(self, scene: str) -> Dict[int, list]:
        cache = self.__dict__.setdefault("_label_cache", {})
        if scene not in cache:
            cache[scene] = parse_label_file(
                os.path.join(self.root, self.version, self._location, self.TO_LABEL_DIR,
                             scene + ".txt"),
                self.max_boxes,
            )
        return cache[scene]

    def get_labels_by_index(self, index: int, offset: int = 0):
        gidx = self._frame_global_index(index, offset)
        scene = self.scene_of_frame[gidx]
        frame_id = int(os.path.basename(self.image_list[gidx]).split(".")[0])
        return self._scene_labels(scene).get(frame_id, [])

    def get_calib_by_index(self, index: int) -> Optional[np.ndarray]:
        gidx = self._frame_global_index(index, 0)
        scene = self.scene_of_frame[gidx]
        calib_file = os.path.join(self.root, self.version, self._location, "calib", scene + ".txt")
        if not os.path.exists(calib_file):
            return None
        with open(calib_file) as f:
            for line in f:
                if "P2:" in line:
                    vals = [float(v) for v in line.strip().split(" ")[1:]]
                    return np.asarray(vals, np.float32).reshape(3, 4)
        return None

    def get_bbox_image_file_by_index(self, index: int, image_file=None):
        if image_file is None:
            image_file = self.image_list[index]
        return image_file.replace(self.TO_IMAGE_DIR, self.TO_BBOX_DIR)

    def get_prompt(self, index: int) -> str:
        return "This is a real-world driving scene set in the German city of Karlsruhe."
