"""Draw every frame's bbox conditioning image of a dataset ahead of training.

    python -m ctrlv_tpu_torch.tools.preprocess_dataset --dataset_name nuscenes --data_root DIR ...

Counterpart of ``tools/preprocess_dataset.py`` (the reference's
``tools/preprocessing/preprocess_dataset.py``): each frame of the training
split, in image mode, drawn by the native rasterizer at
``--train_H`` x ``--train_W`` and written as a PNG where the dataset reads its
preplotted frames (KITTI ``bbox_02``, Virtual KITTI ``bbox``, BDD100K
``bbox/track``), else under ``{output_dir}/bbox_frames``: by token for
nuScenes (its ``my_render_3d_style`` frame), by index for the rest. The
frames are drawn on the host; as every command of the port, the tool wants
the card unless ``--device`` says otherwise.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

from ..data import build_dataset
from ..pipelines.common import resolve_device
from ..utils.config import parse_args


def main(cfg=None) -> int:
    """Returns the number of frames written."""
    cfg = cfg or parse_args()
    resolve_device(cfg.device)
    ds = build_dataset(
        cfg.dataset_name, cfg.data_root, if_train=True, data_type="image",
        clip_length=cfg.clip_length, train_H=cfg.train_H, train_W=cfg.train_W,
        use_preplotted_bbox=False,
    )
    n = ds.num_frames_total()
    print(f"rendering {n} bbox frames for {cfg.dataset_name}")
    is_nusc = cfg.dataset_name == "nuscenes"
    for i in range(n):
        if is_nusc:
            # the reference's my_render_3d_style frame, cached by token
            # (nuscenes_.py:354-384); already in [0, 1]
            token = ds._token_at(i, 0)
            frame01 = ds.render_nusc_bbox_frame(token)
            out_path = ds.get_bbox_image_file_by_index(i) or os.path.join(
                cfg.output_dir, "bbox_frames", f"{token}.png"
            )
        else:
            labels = ds.get_labels_by_index(i)
            calib = ds.get_calib_by_index(i)
            frame01 = ds.render_bbox_frame(labels, calib) * 0.5 + 0.5  # from [-1, 1]
            out_path = ds.get_bbox_image_file_by_index(i) or os.path.join(
                cfg.output_dir, "bbox_frames", f"{i:08d}.png"
            )
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        img = (np.clip(frame01, 0.0, 1.0) * 255).astype(np.uint8)
        Image.fromarray(img).save(out_path)
        if i % 100 == 0:
            print(f"{i}/{n}")
    return n


if __name__ == "__main__":
    main()
