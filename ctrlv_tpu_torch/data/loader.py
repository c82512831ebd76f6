"""Dataset factory and ``torch.utils.data.DataLoader`` of the port.

Counterpart of ``ctrlv_tpu/data/loader.py`` (the reference's
``get_dataloader``, ``utils/util.py:37-93``): the dataset by name, then
batches of ``collate_clip_batch``, drop-last. Unlike the JAX package's
loader (one prefetch thread, ``num_workers`` accepted and ignored), this is
torch's ``DataLoader``, with ``num_workers`` worker processes started by
``spawn``: a worker starts from a fresh interpreter and touches no CUDA.
Shuffling draws the JAX loader's order exactly (``EpochShuffleSampler``).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
from torch.utils.data import DataLoader, Sampler, SequentialSampler

from .collate import collate_clip_batch


def build_dataset(
    dset_name: str,
    dset_root: str,
    if_train: bool,
    data_type: str = "clip",
    clip_length: int = 25,
    if_return_bbox_im: bool = False,
    train_H: int = 320,
    train_W: int = 512,
    use_segmentation: bool = False,
    use_preplotted_bbox: bool = True,
    if_last_frame_traj: bool = False,
    non_overlapping_clips: bool = False,
    **kwargs,
):
    name = dset_name.lower()
    common = dict(
        root=dset_root,
        train=if_train,
        data_type=data_type,
        clip_length=clip_length,
        if_return_bbox_im=if_return_bbox_im,
        train_H=train_H,
        train_W=train_W,
        non_overlapping_clips=non_overlapping_clips,
        use_preplotted_bbox=use_preplotted_bbox,
    )
    if name == "kitti":
        from .kitti import KittiDataset

        return KittiDataset(**common, **kwargs)
    if name == "vkitti":
        from .vkitti import VKittiDataset

        return VKittiDataset(**common, **kwargs)
    if name == "mkitti":
        from .mkitti import MergedKittiDataset

        return MergedKittiDataset(**common, **kwargs)
    if name == "bdd100k":
        from .bdd100k import BDD100KDataset

        ds = BDD100KDataset(use_segmentation=use_segmentation, **common, **kwargs)
        ds.set_if_last_frame_trajectory(if_last_frame_traj)
        return ds
    if name == "davis":
        from .davis import DAVISDataset

        return DAVISDataset(**common, **kwargs)
    if name == "nuscenes":
        from .nuscenes import NuScenesDataset

        return NuScenesDataset(**common, **kwargs)
    if name == "synthetic":
        from .synthetic import SyntheticDrivingDataset

        common.pop("use_preplotted_bbox")
        return SyntheticDrivingDataset(**common, **kwargs)
    raise NotImplementedError(f"Dataset {dset_name} not implemented")


class EpochShuffleSampler(Sampler):
    """The JAX loader's shuffled order: each pass over the loader is the next
    epoch, counted from 1, and permutes the indices with
    ``np.random.default_rng(seed + epoch)``."""

    def __init__(self, n: int, seed: int = 0):
        self.n, self.seed, self.epoch = n, seed, 0

    def __len__(self) -> int:
        return self.n

    def __iter__(self) -> Iterator[int]:
        self.epoch += 1
        idx = np.arange(self.n)
        np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return iter(idx.tolist())


def get_dataloader(
    dset_root: str,
    dset_name: str,
    if_train: bool,
    batch_size: int,
    num_workers: int = 0,
    data_type: str = "clip",
    clip_length: int = 25,
    shuffle: bool = True,
    if_return_bbox_im: bool = False,
    train_H: int = 320,
    train_W: int = 512,
    use_segmentation: bool = False,
    use_preplotted_bbox: bool = True,
    if_last_frame_traj: bool = False,
    non_overlapping_clips: bool = False,
    seed: int = 0,
    pin_memory: bool = False,
    **kwargs,
):
    """(dataset, loader); ``pin_memory`` for a loader that feeds the card."""
    dset = build_dataset(
        dset_name,
        dset_root,
        if_train,
        data_type=data_type,
        clip_length=clip_length,
        if_return_bbox_im=if_return_bbox_im,
        train_H=train_H,
        train_W=train_W,
        use_segmentation=use_segmentation,
        use_preplotted_bbox=use_preplotted_bbox,
        if_last_frame_traj=if_last_frame_traj,
        non_overlapping_clips=non_overlapping_clips,
        **kwargs,
    )
    if len(dset) == 0:
        raise FileNotFoundError(
            f"dataset '{dset_name}' at '{dset_root}' produced 0 "
            f"{data_type}s — check --data_root (expected layout documented "
            f"in ctrlv_tpu_torch/data/{dset_name.lower()}.py)"
        )
    if hasattr(dset, "tracks_in_index_order"):  # nuScenes: its workers number tracks in order
        dset.tracks_in_index_order = not shuffle
    sampler = EpochShuffleSampler(len(dset), seed) if shuffle else SequentialSampler(dset)
    workers = dict(num_workers=num_workers, multiprocessing_context="spawn") if num_workers else {}
    loader = DataLoader(dset, batch_size=batch_size, sampler=sampler, drop_last=True,
                        collate_fn=collate_clip_batch, pin_memory=pin_memory, **workers)
    return dset, loader
