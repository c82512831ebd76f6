"""Merged KITTI + Virtual KITTI dataset (index-dispatch concat).

The port's copy of ``ctrlv_tpu/data/mkitti.py`` (the reference's
``datasets/mkitti.py:45-57``): indices below len(vkitti) go to Virtual
KITTI, the rest to KITTI.
"""

from __future__ import annotations

import dataclasses

from .base import VideoDataset
from .kitti import KittiDataset
from .vkitti import VKittiDataset


@dataclasses.dataclass
class MergedKittiDataset(VideoDataset):
    def __post_init__(self):
        kwargs = dict(
            root=self.root,
            train=self.train,
            data_type=self.data_type,
            clip_length=self.clip_length,
            if_return_bbox_im=self.if_return_bbox_im,
            train_H=self.train_H,
            train_W=self.train_W,
            use_preplotted_bbox=self.use_preplotted_bbox,
            non_overlapping_clips=self.non_overlapping_clips,
        )
        self.vkitti = VKittiDataset(**kwargs)
        self.kitti = KittiDataset(**kwargs)

    def __len__(self):
        return len(self.vkitti) + len(self.kitti)

    def _dispatch(self, index):
        if index < len(self.vkitti):
            return self.vkitti, index
        return self.kitti, index - len(self.vkitti)

    def __getitem__(self, index):
        ds, sub = self._dispatch(index)
        sample = ds[sub]
        sample["index"] = index
        return sample

    def get_frame_file_by_index(self, index, offset=0):
        ds, sub = self._dispatch(index)
        return ds.get_frame_file_by_index(sub, offset)

    def get_labels_by_index(self, index, offset=0):
        ds, sub = self._dispatch(index)
        return ds.get_labels_by_index(sub, offset)

    def get_calib_by_index(self, index):
        ds, sub = self._dispatch(index)
        return ds.get_calib_by_index(sub)

    def get_prompt(self, index):
        ds, sub = self._dispatch(index)
        return ds.get_prompt(sub)
