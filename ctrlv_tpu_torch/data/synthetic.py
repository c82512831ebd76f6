"""Synthetic driving-scene dataset: procedural clips for tests and the card.

The port's copy of ``ctrlv_tpu/data/synthetic.py``: constant-velocity 3D
boxes on a textured background seen by a pinhole camera, with KITTI's label
schema and rasterization path, so the tools run without a dataset on disk.
Clips are seeded per index and equal to the JAX package's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..ops.rasterize import project_boxes_3d_np
from .base import VideoDataset


@dataclasses.dataclass
class SyntheticDrivingDataset(VideoDataset):
    num_clips: int = 8
    num_objects: int = 4
    seed: int = 0

    def __post_init__(self):
        self.orig_H, self.orig_W = self.train_H, self.train_W
        # pinhole calibration similar in spirit to KITTI P2
        f = 0.9 * self.train_W
        self.calib = np.asarray(
            [
                [f, 0.0, self.train_W / 2, 0.0],
                [0.0, f, self.train_H / 2, 0.0],
                [0.0, 0.0, 1.0, 0.0],
            ],
            np.float32,
        )

    def __len__(self) -> int:
        return self.num_clips

    def num_frames_total(self) -> int:
        return self.num_clips * self.clip_length

    def _clip_rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng(self.seed * 100003 + index)

    def _trajectories(self, index: int):
        rng = self._clip_rng(index)
        n = self.num_objects
        start = np.stack(
            [
                rng.uniform(-8, 8, n),  # x
                rng.uniform(1.2, 1.8, n),  # y (ground-ish)
                rng.uniform(8, 30, n),  # z depth
            ],
            axis=-1,
        )
        vel = np.stack(
            [rng.uniform(-0.3, 0.3, n), np.zeros(n), rng.uniform(-0.8, 0.2, n)],
            axis=-1,
        )
        dims = np.stack(
            [rng.uniform(1.4, 1.8, n), rng.uniform(1.6, 2.0, n), rng.uniform(3.5, 4.5, n)],
            axis=-1,
        )  # h, w, l
        rot = rng.uniform(-np.pi, np.pi, n)
        types = rng.integers(1, 4, n)  # Car/Van/Truck
        return start, vel, dims, rot, types

    def get_frame_file_by_index(self, index: int, offset: int = 0) -> str:
        return f"synthetic://{index}/{offset}"

    def load_image(self, path: str) -> np.ndarray:
        index, offset = (int(x) for x in path.split("//")[1].split("/"))
        rng = self._clip_rng(index)
        # textured moving background: deterministic per clip
        yy, xx = np.mgrid[0 : self.train_H, 0 : self.train_W].astype(np.float32)
        phase = rng.uniform(0, 2 * np.pi)
        base = 0.4 + 0.2 * np.sin(xx / 37.0 + phase + 0.11 * offset) * np.cos(
            yy / 23.0 + phase
        )
        img = np.stack([base, base * 0.9, base * 0.8], axis=-1)
        # paint the objects as filled 2D boxes so the RGB clip correlates
        labels = self.get_labels_by_index(index, offset)
        for lab in labels:
            x1, y1, x2, y2 = (int(max(v, 0)) for v in lab["bbox"])
            x2 = min(x2, self.train_W - 1)
            y2 = min(y2, self.train_H - 1)
            if x2 > x1 and y2 > y1:
                color = np.asarray([0.8, 0.2, 0.2]) * (0.5 + 0.5 * (lab["id_type"] / 4))
                img[y1:y2, x1:x2] = color
        return self.to_tensor(np.clip(img, 0, 1))

    def get_labels_by_index(self, index: int, offset: int = 0) -> List[dict]:
        start, vel, dims, rot, types = self._trajectories(index)
        pos = start + vel * offset
        all_corners = project_boxes_3d_np(
            pos.astype(np.float32), dims.astype(np.float32),
            rot.astype(np.float32), np.asarray(self.calib),
        )
        labels = []
        for i in range(self.num_objects):
            corners = all_corners[i]
            x1, y1 = corners.min(axis=0)
            x2, y2 = corners.max(axis=0)
            if x2 < 0 or x1 > self.train_W or y2 < 0 or y1 > self.train_H:
                continue
            labels.append(
                dict(
                    frame=offset,
                    trackID=i,
                    type="Car",
                    truncated=0.0,
                    occluded=0,
                    alpha=0.0,
                    bbox=[float(x1), float(y1), float(x2), float(y2)],
                    dimensions=[float(d) for d in dims[i]],
                    location=[float(p) for p in pos[i]],
                    rotation_y=float(rot[i]),
                    id_type=int(types[i]),
                )
            )
        return labels

    def get_calib_by_index(self, index: int) -> Optional[np.ndarray]:
        return self.calib

    def get_prompt(self, index: int) -> str:
        return "A synthetic driving scene."
