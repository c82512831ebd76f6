"""Evaluation sample generators.

The port's copy of ``ctrlv_tpu/utils/samples.py`` (the reference's
``utils/util.py:241-307``): ``get_first_training_sample`` assembles the eval
dict (the ground-truth clip, bbox frames, the first image, calibration,
labels) from the first element of a collated batch, ``get_n_training_samples``
and ``eval_samples_generator`` walk a loader, and
``eval_demo_samples_generator`` replays pickled demo samples. Arrays in the
dict are numpy; ``objects_tensors`` is the batch's own.
"""

from __future__ import annotations

import pickle
from typing import Iterator, List

import numpy as np


def get_first_training_sample(batch: dict, dataset) -> dict:
    """First element of a collated batch -> eval sample dict."""
    clip = np.asarray(batch["clips"][0], np.float32)  # (F, H, W, 3) in [-1, 1]
    gt_clip_np = (dataset.revert_transform(clip) * 255).astype(np.uint8)
    index = batch["indices"][0]
    sample = dict(
        gt_clip=clip,
        gt_clip_np=gt_clip_np,
        objects_tensors=batch["objects"],
        image_init=clip[0],
        gt_labels=[
            dataset.get_labels_by_index(index, off) for off in range(clip.shape[0])
        ],
        cam_to_img=dataset.get_calib_by_index(index),
        index=index,
    )
    if batch.get("bbox_images") is not None:
        bbox = np.asarray(batch["bbox_images"][0], np.float32)
        sample["bbox_img"] = bbox
        sample["bbox_img_np"] = (dataset.revert_transform(bbox) * 255).astype(np.uint8)
        sample["bbox_init"] = bbox[0]
    return sample


def get_n_training_samples(loader, n_samples: int) -> List[dict]:
    samples = []
    for i, batch in enumerate(iter(loader)):
        if i >= n_samples:
            break
        samples.append(get_first_training_sample(batch, loader.dataset))
    return samples


def eval_samples_generator(loader, start_index: int = 0) -> Iterator[dict]:
    if loader.batch_size != 1:
        raise ValueError(f"eval_samples_generator walks a loader of batch size 1, not "
                         f"{loader.batch_size}")
    for i, batch in enumerate(iter(loader)):
        if i < start_index:
            continue
        yield get_first_training_sample(batch, loader.dataset)


def eval_demo_samples_generator(pkl_files) -> Iterator[dict]:
    """Demo samples pickled by this program or the reference's trainer: a
    pickle runs code as it loads, so give it no file of unknown origin."""
    for path in pkl_files:
        with open(path, "rb") as f:
            yield pickle.load(f)
