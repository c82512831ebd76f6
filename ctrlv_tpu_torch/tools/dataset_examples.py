"""Walk the datasets: one batch of each that is present, with its shapes.

    python -m ctrlv_tpu_torch.tools.dataset_examples --data_root DIR [--device cpu]

Counterpart of ``tools/dataset_examples.py`` (the reference's
``tools/preprocessing/dataset_examples.py``, which drops into pdb): for each
of the synthetic, KITTI, Virtual KITTI, merged KITTI, BDD100K and DAVIS
datasets, the first batch of a training loader (clips of at most 5 frames at
64x96, with their bbox frames) moved to the device, and one line with the
dataset's length and the batch's shapes, or the reason it is unavailable;
the lines are the JAX tool's. The loader reads in this process
(``num_workers=0``, where the JAX tool turns its prefetch thread off). The
batches go to the card unless ``--device`` says otherwise.
"""

from __future__ import annotations

from ..data import get_dataloader
from ..pipelines.common import resolve_device
from ..utils.config import parse_args
from .common import batch_to_device

NAMES = ("synthetic", "kitti", "vkitti", "mkitti", "bdd100k", "davis")


def main(cfg=None) -> list:
    """Returns the printed lines."""
    cfg = cfg or parse_args()
    device = resolve_device(cfg.device)
    lines = []
    for name in NAMES:
        try:
            ds, loader = get_dataloader(
                cfg.data_root, name, if_train=True, batch_size=1,
                clip_length=min(cfg.clip_length, 5), if_return_bbox_im=True,
                train_H=64, train_W=96, num_workers=0,
            )
            if len(ds) == 0:
                line = f"{name}: present but empty (no data at {cfg.data_root})"
            else:
                batch = next(iter(loader))
                batch_to_device(batch, device)
                shapes = {k: tuple(v.shape) for k, v in batch.items() if hasattr(v, "shape")}
                bbox = batch.get("bbox_images")
                line = (f"{name}: {len(ds)} samples, clips={shapes.get('clips')}, "
                        f"bbox_images={() if bbox is None else tuple(bbox.shape)}, "
                        f"objects.bbox={tuple(batch['objects']['bbox'].shape)}")
        except Exception as e:  # noqa: BLE001 — a walk-through reports and goes on
            line = f"{name}: unavailable ({type(e).__name__}: {e})"
        print(line)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
