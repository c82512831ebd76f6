"""Virtual KITTI 2 dataset.

The port's copy of ``ctrlv_tpu/data/vkitti.py`` (the reference's
``datasets/vkitti.py``): the vkitti_2.0.3 layout (Scene01/02/06/18 train,
Scene20 test; 6 weather settings; frames/rgb/Camera_0), bbox.txt, info.txt
and pose.txt joined per frame, number_pixels > 350, DontCare dropped, a
prompt per scene and setting, the K matrix of intrinsic.txt, preplotted bbox
frames by the rgb -> bbox path substitution.

The JAX package reads the tables with pandas; this reads the space-separated
tables itself (``read_table``), giving the same labels.
"""

from __future__ import annotations

import dataclasses
import os

from typing import Dict, List, Optional

import numpy as np

from .base import VideoDataset
from .kitti import CLASS_IDS_LOOKUP

SCENE_LOOKUP = {
    "Scene01": "Crowded urban area",
    "Scene02": "Urban area",
    "Scene06": "Busy intersection",
    "Scene18": "Long road in the forest",
    "Scene20": "Highway",
}
SETTINGS = ("clone", "fog", "morning", "overcast", "rain", "sunset")
PIXEL_THRES = 350


def _value(token: str):
    for cast in (int, float):
        try:
            return cast(token)
        except ValueError:
            pass
    return token


def read_table(path: str) -> List[Dict[str, object]]:
    """A space-separated table with a header row -> one dict a row, each
    value an int, a float or else the string."""
    with open(path) as f:
        lines = [line.strip() for line in f if line.strip()]
    cols = lines[0].split(" ")
    rows = []
    for line in lines[1:]:
        vals = line.split(" ")
        if len(vals) != len(cols):
            raise ValueError(f"{path}: a row has {len(vals)} fields, the header {len(cols)}")
        rows.append(dict(zip(cols, (_value(v) for v in vals))))
    return rows


@dataclasses.dataclass
class VKittiDataset(VideoDataset):
    version: str = "vkitti_2.0.3"
    max_boxes: int = 30

    TRAINING = ("Scene01", "Scene02", "Scene06", "Scene18")
    TESTING = ("Scene20",)
    TO_RGB = "frames/rgb/Camera_0"

    def __post_init__(self):
        self.image_list: List[str] = []
        self.label_dir_of_frame: List[str] = []
        self.clip_list: List[List[int]] = []
        rgb_root = os.path.join(self.root, self.version, "rgb")
        text_root = os.path.join(self.root, self.version, "textgt")
        scenes = self.TRAINING if self.train else self.TESTING
        for scene in scenes:
            for setting in SETTINGS:
                frame_dir = os.path.join(rgb_root, scene, setting, self.TO_RGB)
                if not os.path.isdir(frame_dir):
                    continue
                label_dir = os.path.join(text_root, scene, setting)
                idxs = []
                for f in sorted(os.listdir(frame_dir)):
                    self.image_list.append(os.path.join(frame_dir, f))
                    self.label_dir_of_frame.append(label_dir)
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
        return (
            len(self.image_list) if self.data_type == "image" else len(self.clip_list)
        )

    def num_frames_total(self) -> int:
        return len(self.image_list)

    def _frame_global_index(self, index: int, offset: int) -> int:
        return index if self.data_type == "image" else self.clip_list[index][offset]

    def get_frame_file_by_index(self, index: int, offset: int = 0) -> str:
        return self.image_list[self._frame_global_index(index, offset)]

    def _label_tables(self, label_dir: str):
        cache = self.__dict__.setdefault("_label_cache", {})
        if label_dir not in cache:
            cache[label_dir] = tuple(
                read_table(os.path.join(label_dir, name))
                for name in ("bbox.txt", "info.txt", "pose.txt")
            )
        return cache[label_dir]

    def _frame_id(self, gidx: int) -> int:
        return int(os.path.basename(self.image_list[gidx]).split("_")[-1].split(".")[0])

    def get_labels_by_index(self, index: int, offset: int = 0) -> List[dict]:
        gidx = self._frame_global_index(index, offset)
        frame_id = self._frame_id(gidx)
        bbox, info, pose = self._label_tables(self.label_dir_of_frame[gidx])
        type_of_track = {r["trackID"]: r["label"] for r in info}
        pose_f = [r for r in pose if r["frame"] == frame_id and r["cameraID"] == 0]
        labels = []
        for row in bbox:
            if row["frame"] != frame_id or row["cameraID"] != 0:
                continue
            obj_type = type_of_track.get(row["trackID"])
            if obj_type == "DontCare" or obj_type is None:
                continue
            if row["number_pixels"] <= PIXEL_THRES:
                continue
            p = [r for r in pose_f if r["trackID"] == row["trackID"]]
            if len(p) != 1:
                continue
            p = p[0]
            labels.append(
                dict(
                    frame=frame_id,
                    trackID=int(row["trackID"]),
                    type=obj_type,
                    truncated=float(row["truncation_ratio"]),
                    occluded=float(row["occupancy_ratio"]),
                    alpha=float(p["alpha"]),
                    bbox=[row["left"], row["top"], row["right"], row["bottom"]],
                    dimensions=[p["height"], p["width"], p["length"]],
                    location=[
                        p["camera_space_X"], p["camera_space_Y"], p["camera_space_Z"]
                    ],
                    rotation_y=float(p["rotation_camera_space_y"]),
                    id_type=CLASS_IDS_LOOKUP.get(obj_type, 8),
                )
            )
            if len(labels) >= self.max_boxes:
                break
        return labels

    def get_calib_by_index(self, index: int) -> Optional[np.ndarray]:
        gidx = self._frame_global_index(index, 0)
        intr = os.path.join(self.label_dir_of_frame[gidx], "intrinsic.txt")
        if not os.path.exists(intr):
            return None
        frame_id = self._frame_id(gidx)
        row = next(r for r in read_table(intr) if r["frame"] == frame_id and r["cameraID"] == 0)
        K = np.zeros((3, 3), np.float32)
        K[0, 0] = row["K[0,0]"]
        K[0, 2] = row["K[0,2]"]
        K[1, 1] = row["K[1,1]"]
        K[1, 2] = row["K[1,2]"]
        K[2, 2] = 1.0
        return K

    def get_bbox_image_file_by_index(self, index: int = None, image_file=None):
        if image_file is None:
            image_file = self.image_list[self._frame_global_index(index, 0)]
        return image_file.replace("rgb", "bbox")

    def get_prompt(self, index: int) -> str:
        gidx = self._frame_global_index(index, 0)
        path = self.image_list[gidx]
        setting = next((s for s in SETTINGS if s in path), "clone")
        scene_idx = path.find("Scene")
        scene = SCENE_LOOKUP.get(path[scene_idx : scene_idx + 7], "driving scene")
        joiner = "in the" if setting in ("morning", "rain", "fog") else "during"
        shown = setting if setting != "clone" else "daytime"
        return f"This is a simulated driving scene set in a {scene.lower()} {joiner} {shown}."
