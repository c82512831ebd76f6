"""Abstract video dataset: transforms, clip assembly, bbox-frame rendering.

Counterpart of ``ctrlv_tpu/data/base.py`` (the reference's
``KittiAbstract``, ``datasets/kitti_abstract.py:11-256``):

- frames resized to (train_H, train_W) and scaled to [-1, 1], channels last;
- clips assembled from per-frame files, optionally without overlap;
- per-frame label dicts (type, truncated, occluded, alpha, bbox, dimensions,
  location, rotation_y, id_type, trackID);
- conditioning frames loaded from preplotted images or drawn on the host;
- the last frame replaced by a trajectory frame where asked.

Samples are numpy; ``collate.collate_clip_batch`` makes tensors of them.
Every frame is drawn by the native C++ rasterizer. The JAX package draws
the trajectory frame with its XLA rasterizer instead: the two agree on all
but a few pixels on segment and circle edges (held to under 0.2 %).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np

from ..ops.rasterize import TYPE_COLORS, project_boxes_3d_np, track_color
from .collate import objects_to_arrays
from .native import rasterize_frame_native, rasterize_trajectory_native

FrameLabel = Dict[str, object]  # one object's label dict


@dataclasses.dataclass
class VideoDataset:
    """Base class. Subclasses implement the per-dataset indexing and parsing."""

    root: str = "."
    train: bool = True
    data_type: str = "clip"  # "image" | "clip"
    clip_length: int = 25
    if_return_bbox_im: bool = False
    train_H: int = 320
    train_W: int = 512
    use_preplotted_bbox: bool = True
    non_overlapping_clips: bool = False
    if_last_frame_trajectory: bool = False

    # subclass-populated
    orig_H: int = 375
    orig_W: int = 1242
    fps: int = 7

    # ------------------------------------------------------------------
    # transforms
    def load_image(self, path: str) -> np.ndarray:
        from PIL import Image

        img = Image.open(path).convert("RGB").resize((self.train_W, self.train_H))
        return self.to_tensor(np.asarray(img, np.float32) / 255.0)

    @staticmethod
    def to_tensor(img01: np.ndarray) -> np.ndarray:
        """[0, 1] (H, W, 3) -> [-1, 1] float32, channels last."""
        return (np.asarray(img01, np.float32) - 0.5) / 0.5

    @staticmethod
    def revert_transform(img: np.ndarray) -> np.ndarray:
        """[-1, 1] -> [0, 1]."""
        return np.clip(img * 0.5 + 0.5, 0.0, 1.0)

    # ------------------------------------------------------------------
    # subclass interface
    def num_frames_total(self) -> int:
        raise NotImplementedError

    def get_frame_file_by_index(self, index: int, offset: int = 0) -> str:
        """Resolve (clip index, frame offset) -> image path."""
        raise NotImplementedError

    def get_labels_by_index(self, index: int, offset: int = 0) -> Optional[List[FrameLabel]]:
        raise NotImplementedError

    def get_calib_by_index(self, index: int) -> Optional[np.ndarray]:
        return None

    def get_bbox_image_file_by_index(self, index: int = None, image_file=None) -> Optional[str]:
        return None

    def get_prompt(self, index: int) -> str:
        return "A driving scene."

    def __len__(self) -> int:
        if self.data_type == "image":
            return self.num_frames_total()
        if self.non_overlapping_clips:
            return self.num_frames_total() // self.clip_length
        return max(self.num_frames_total() - self.clip_length + 1, 0)

    # ------------------------------------------------------------------
    def _scaled_objects(self, labels):
        """The frame's padded objects with boxes scaled to the training size,
        their valid mask and their type and track colours."""
        arrays = objects_to_arrays([labels])
        sx = self.train_W / self.orig_W
        sy = self.train_H / self.orig_H
        bbox = arrays["bbox"][0] * np.asarray([sx, sy, sx, sy], np.float32)
        valid = np.arange(bbox.shape[0]) < arrays["num_objects"][0]
        tcol = TYPE_COLORS[np.clip(arrays["id_type"][0], 0, len(TYPE_COLORS) - 1)]
        kcol = track_color(arrays["track_id"][0])
        return arrays, (sx, sy), bbox, valid, tcol, kcol

    def render_bbox_frame(
        self, labels: Optional[List[FrameLabel]], calib: Optional[np.ndarray]
    ) -> np.ndarray:
        """Draw one conditioning frame -> [-1, 1] numpy."""
        arrays, (sx, sy), bbox, valid, tcol, kcol = self._scaled_objects(labels)
        if calib is None:
            corners = np.full((bbox.shape[0], 8, 2), -1e4, np.float32)
        else:
            calib_used = np.asarray(calib, np.float32)
            if calib_used.shape != (3, 4):
                calib_used = np.pad(calib_used, ((0, 0), (0, 1)))
            calib_used = np.diag([sx, sy, 1.0]).astype(np.float32) @ calib_used
            corners = project_boxes_3d_np(
                arrays["locations"][0], arrays["dimensions"][0],
                arrays["rotation_y"][0], calib_used,
            )
        frame = rasterize_frame_native(
            corners, bbox, valid, tcol, kcol, height=self.train_H, width=self.train_W
        )
        return self.to_tensor(frame)

    def render_trajectory_frame(self, labels: Optional[List[FrameLabel]]) -> np.ndarray:
        """Draw one trajectory frame (a dot at each box centre) -> [-1, 1]."""
        _, _, bbox, valid, tcol, kcol = self._scaled_objects(labels)
        centers = np.stack(
            [(bbox[:, 0] + bbox[:, 2]) / 2, (bbox[:, 1] + bbox[:, 3]) / 2], axis=-1
        )
        frame = rasterize_trajectory_native(
            centers, valid, tcol, kcol, height=self.train_H, width=self.train_W
        )
        return self.to_tensor(frame)

    def load_bbox_frame(self, index: int, offset: int, labels, calib) -> np.ndarray:
        path = None
        if self.use_preplotted_bbox:
            try:
                path = self.get_bbox_image_file_by_index(
                    image_file=self.get_frame_file_by_index(index, offset)
                )
            except TypeError:
                path = self.get_bbox_image_file_by_index(index)
        if path is not None and os.path.exists(path):
            return self.load_image(path)
        return self.render_bbox_frame(labels, calib)

    # ------------------------------------------------------------------
    def __getitem__(self, index: int) -> dict:
        if self.data_type == "image":
            img = self.load_image(self.get_frame_file_by_index(index))
            labels = self.get_labels_by_index(index)
            return dict(
                clip=img,
                labels=[labels],
                prompt=self.get_prompt(index),
                index=index,
                bbox_images=None,
            )

        calib = self.get_calib_by_index(index)
        frames, labels_per_frame, bbox_frames = [], [], []
        for off in range(self.clip_length):
            frames.append(self.load_image(self.get_frame_file_by_index(index, off)))
            labels = self.get_labels_by_index(index, off)
            labels_per_frame.append(labels)
            if self.if_return_bbox_im:
                bbox_frames.append(self.load_bbox_frame(index, off, labels, calib))

        sample = dict(
            clip=np.stack(frames),
            labels=labels_per_frame,
            prompt=self.get_prompt(index),
            index=index,
            cam_to_img=calib,
        )
        if self.if_return_bbox_im:
            if self.if_last_frame_trajectory:
                bbox_frames[-1] = self.render_trajectory_frame(labels_per_frame[-1])
            sample["bbox_images"] = np.stack(bbox_frames)
        return sample
