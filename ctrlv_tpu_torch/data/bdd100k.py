"""BDD100K tracking dataset (2D boxes only).

The port's copy of ``ctrlv_tpu/data/bdd100k.py`` (the reference's
``datasets/bdd100k.py``):
images/track/{train,val}/<clip>/<clip>-NNNNNNN.jpg folders; JSON
box_track_20 labels (category/id/box2d/attributes), 10-class lookup,
30-box cap; train clips are sliding windows within a folder, val clips
are non-overlapping chunks; optional segmentation-colormap conditioning
and trajectory last frame; no calibration (2D rects only).
"""

from __future__ import annotations

import dataclasses
import json
import os

from typing import List

from .base import VideoDataset

CLASS_IDS_LOOKUP = {
    "pedestrian": 1,
    "rider": 2,
    "car": 3,
    "truck": 4,
    "bus": 5,
    "train": 6,
    "motorcycle": 7,
    "bicycle": 8,
    "traffic light": 9,
    "traffic sign": 10,
}
TO_COCO_LABELS = {1: 0, 2: 0, 3: 2, 4: 7, 5: 5, 6: 6, 7: 3, 8: 1}

TO_IMAGE_DIR = "images/track"
TO_BBOX_DIR = "bbox/track"
TO_BBOX_LABELS = "labels/box_track_20"
TO_SEG_LABELS = "labels/seg_track_20/colormaps"


@dataclasses.dataclass
class BDD100KDataset(VideoDataset):
    version: str = "bdd100k"
    use_segmentation: bool = False
    max_boxes: int = 30

    def __post_init__(self):
        self.orig_H, self.orig_W = 720, 1280
        self.fps = 5
        self._location = "train" if self.train else "val"
        self.image_dir = os.path.join(self.root, self.version, TO_IMAGE_DIR, self._location)
        self.bbox_label_dir = os.path.join(
            self.root, self.version, TO_BBOX_LABELS, self._location
        )
        if self.use_segmentation:
            seg_dir = os.path.join(self.root, self.version, TO_SEG_LABELS, self._location)
            folders = sorted(os.listdir(seg_dir)) if os.path.isdir(seg_dir) else []
        else:
            folders = (
                sorted(d for d in os.listdir(self.image_dir) if d != "pred")
                if os.path.isdir(self.image_dir)
                else []
            )
        self.clip_folders = folders
        self.clip_folder_lengths = {
            k: len(os.listdir(os.path.join(self.image_dir, k))) for k in folders
        }
        # flat frame index + clip windows
        self.image_list: List[str] = []
        self.clip_list: List[List[int]] = []
        for folder in folders:
            n = self.clip_folder_lengths[folder]
            start = len(self.image_list)
            for i in range(1, n + 1):
                self.image_list.append(
                    os.path.join(self.image_dir, folder, f"{folder}-{i:07d}.jpg")
                )
            idxs = list(range(start, start + n))
            if self.data_type == "clip":
                if self.train and not self.non_overlapping_clips:
                    for i in range(n - self.clip_length + 1):
                        self.clip_list.append(idxs[i : i + self.clip_length])
                else:
                    for ci in range(n // self.clip_length):
                        self.clip_list.append(
                            idxs[ci * self.clip_length : (ci + 1) * self.clip_length]
                        )

    def __len__(self):
        return len(self.image_list) if self.data_type == "image" else len(self.clip_list)

    def num_frames_total(self):
        return len(self.image_list)

    def _frame_global_index(self, index, offset):
        return index if self.data_type == "image" else self.clip_list[index][offset]

    def get_frame_file_by_index(self, index, offset=0):
        return self.image_list[self._frame_global_index(index, offset)]

    def _clip_labels(self, clip_id: str):
        cache = self.__dict__.setdefault("_label_cache", {})
        if clip_id not in cache:
            with open(os.path.join(self.bbox_label_dir, f"{clip_id}.json")) as f:
                cache[clip_id] = json.load(f)
        return cache[clip_id]

    def get_labels_by_index(self, index, offset=0) -> List[dict]:
        path = self.get_frame_file_by_index(index, offset)
        clip_id = os.path.basename(os.path.dirname(path))
        frame_name = os.path.basename(path)
        frames = self._clip_labels(clip_id)
        frame_i = int(frame_name[-11:-4]) - 1
        entry = frames[frame_i]
        labels = []
        for obj in entry.get("labels", []):
            if obj["category"] not in CLASS_IDS_LOOKUP:
                continue
            attrs = obj.get("attributes", {})
            labels.append(
                dict(
                    frame=frame_name,
                    trackID=int(obj["id"]),
                    type=obj["category"],
                    truncated=float(attrs.get("truncated", 0.0)),
                    occluded=int(bool(attrs.get("occluded", 0))),
                    alpha=0.0,
                    bbox=[
                        obj["box2d"]["x1"], obj["box2d"]["y1"],
                        obj["box2d"]["x2"], obj["box2d"]["y2"],
                    ],
                    dimensions=[0.0, 0.0, 0.0],
                    location=[0.0, 0.0, 0.0],
                    rotation_y=0.0,
                    id_type=CLASS_IDS_LOOKUP[obj["category"]],
                )
            )
            if len(labels) >= self.max_boxes:
                break
        return labels

    def get_calib_by_index(self, index):
        return None  # BDD100K is 2D-only

    def get_bbox_image_file_by_index(self, index=None, image_file=None):
        if image_file is None:
            image_file = self.image_list[self._frame_global_index(index, 0)]
        if self.use_segmentation:
            return image_file.replace(TO_IMAGE_DIR, TO_SEG_LABELS)[:-4] + ".png"
        return image_file.replace(TO_IMAGE_DIR, TO_BBOX_DIR)

    def get_prompt(self, index):
        return "This is a real-world driving scene."

    def set_if_last_frame_trajectory(self, flag: bool):
        self.if_last_frame_trajectory = flag
