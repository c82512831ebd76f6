"""The port's data path: datasets, collation and the loader.

Counterpart of ``ctrlv_tpu/data``: the synthetic, KITTI, Virtual KITTI,
merged KITTI, BDD100K, DAVIS and nuScenes datasets. It imports neither JAX
nor the JAX package; frames are drawn by the native C++ rasterizer.
"""

from .base import FrameLabel, VideoDataset
from .bdd100k import BDD100KDataset
from .collate import (
    COCO_LABELS_LOOKUP,
    MAX_BOXES_PER_DATA,
    collate_clip_batch,
    init_objects,
    objects_to_arrays,
)
from .davis import DAVISDataset
from .kitti import KittiDataset
from .loader import EpochShuffleSampler, build_dataset, get_dataloader
from .mkitti import MergedKittiDataset
from .nuscenes import NuScenesDataset
from .synthetic import SyntheticDrivingDataset
from .vkitti import VKittiDataset
