"""The port's data path against the JAX package's, on the CPU.

The synthetic dataset, and KITTI, Virtual KITTI (alone and merged with
KITTI) and BDD100K trees the tests write (as tests/test_datasets_fixtures.py
does, plus a KITTI calibration and BDD100K segmentation colormaps), give the
same samples in both packages: clips, labels and conditioning frames equal
bit for bit (both draw the frames with
the native rasterizer). DAVIS trees as tests/test_datasets_fixtures.py writes them give the
same samples in train, val and image modes. The trajectory frame is the one departure: the port
draws it with the native rasterizer, the JAX package with its XLA one, and
they may differ on circle edges, under 0.2 % of the pixels (the rule of
tests/test_native.py). Collated batches are equal; the loader's shuffled
order is the JAX loader's for two seeds over two epochs; two worker
processes give the same batches as none.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from ctrlv_tpu.data import build_dataset as jax_build_dataset
from ctrlv_tpu.data import collate_clip_batch as jax_collate
from ctrlv_tpu.data import get_dataloader as jax_get_dataloader
from ctrlv_tpu_torch.data import build_dataset, collate_clip_batch, get_dataloader
from ctrlv_tpu_torch.ops.rasterize import TYPE_COLORS, project_boxes_3d_np, track_color
from test_datasets_fixtures import _make_kitti, _make_vkitti

H, W, CLIP = 36, 64, 3
CLIP_ID = "b1c9c847-3bda4659"


def _assert_trajectory_close(out, ref):
    """Native against XLA: at most 0.2 % of the pixels apart by more than 1e-4."""
    mismatched = np.abs(out - ref).max(axis=-1) > 1e-4
    assert mismatched.mean() < 0.002, f"{mismatched.sum()} mismatched pixels"


def _assert_samples_equal(out, ref, trajectory: bool):
    assert sorted(out) == sorted(ref)
    assert out["index"] == ref["index"] and out["prompt"] == ref["prompt"]
    np.testing.assert_array_equal(out["clip"], ref["clip"])
    assert (out["cam_to_img"] is None) == (ref["cam_to_img"] is None)
    if ref["cam_to_img"] is not None:
        np.testing.assert_array_equal(out["cam_to_img"], ref["cam_to_img"])
    for lo, lr in zip(out["labels"], ref["labels"]):
        assert len(lo) == len(lr)
        for a, b in zip(lo, lr):
            assert sorted(a) == sorted(b)
            for k in b:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    last = -1 if trajectory else None
    np.testing.assert_array_equal(out["bbox_images"][:last], ref["bbox_images"][:last])
    if trajectory:
        _assert_trajectory_close(out["bbox_images"][-1], ref["bbox_images"][-1])
        assert (out["bbox_images"][-1] > -1).any()  # a dot was drawn


def _both(name, root, **kw):
    kw = dict(dict(if_train=True, clip_length=CLIP, if_return_bbox_im=True, train_H=H, train_W=W),
              **kw)
    return build_dataset(name, root, **kw), jax_build_dataset(name, root, **kw)


def test_host_helpers_equal_jax():
    from ctrlv_tpu.ops import rasterize as jax_rasterize

    ids = np.arange(-3, 40)
    np.testing.assert_array_equal(track_color(ids), jax_rasterize.track_color(ids))
    assert np.array_equal(track_color(np.int64(7)), jax_rasterize.track_color(np.int64(7)))
    np.testing.assert_array_equal(TYPE_COLORS, jax_rasterize.TYPE_COLORS)
    rng = np.random.default_rng(0)
    loc, dims = rng.uniform(1, 9, (5, 3)).astype(np.float32), rng.uniform(1, 4, (5, 3)).astype(
        np.float32)
    rot, calib = rng.uniform(-3, 3, 5).astype(np.float32), rng.uniform(0, 500, (3, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(project_boxes_3d_np(loc, dims, rot, calib),
                                  jax_rasterize.project_boxes_3d_np(loc, dims, rot, calib))


@pytest.mark.parametrize("trajectory", [False, True])
def test_synthetic_samples_equal_jax(trajectory):
    ours, ref = _both("synthetic", ".", if_last_frame_traj=False, num_clips=3, seed=4)
    ours.if_last_frame_trajectory = ref.if_last_frame_trajectory = trajectory
    assert len(ours) == len(ref) == 3
    for i in (0, 2):
        _assert_samples_equal(ours[i], ref[i], trajectory)


def test_kitti_samples_equal_jax(tmp_path):
    _make_kitti(tmp_path, n=6)
    calib = tmp_path / "kitti" / "training" / "calib"
    calib.mkdir()
    p2 = "721.5 0.0 609.5 44.8 0.0 721.5 172.8 0.2 0.0 0.0 1.0 0.003"
    (calib / "0000.txt").write_text(f"P0: {p2}\nP2: {p2}\n")
    ours, ref = _both("kitti", str(tmp_path))
    assert len(ours) == len(ref) == 3
    sample = ours[1]
    assert sample["cam_to_img"].shape == (3, 4) and (sample["bbox_images"] > -1).any()
    _assert_samples_equal(sample, ref[1], trajectory=False)


@pytest.mark.parametrize("name", ["vkitti", "mkitti"])
def test_vkitti_and_mkitti_samples_equal_jax(tmp_path, name):
    _make_kitti(tmp_path, n=6)
    _make_vkitti(tmp_path, n=5)
    ours, ref = _both(name, str(tmp_path), use_preplotted_bbox=False)
    assert len(ours) == len(ref) == (5 if name == "mkitti" else 2)
    for i in range(len(ref)):
        assert ours.get_prompt(i) == ref.get_prompt(i)
    sample = ours[1]
    assert sample["cam_to_img"].shape == (3, 3) and (sample["bbox_images"] > -1).any()
    _assert_samples_equal(sample, ref[1], trajectory=False)
    if name == "mkitti":  # an index past Virtual KITTI's goes to KITTI
        _assert_samples_equal(ours[4], ref[4], trajectory=False)


def _make_bdd100k(root, n=5):
    img_dir = root / "bdd100k/images/track/train" / CLIP_ID
    seg_dir = root / "bdd100k/labels/seg_track_20/colormaps/train" / CLIP_ID
    lbl_dir = root / "bdd100k/labels/box_track_20/train"
    for d in (img_dir, seg_dir, lbl_dir):
        d.mkdir(parents=True)
    frames = []
    for i in range(1, n + 1):
        name = f"{CLIP_ID}-{i:07d}"
        Image.new("RGB", (128, 72), (30, 60, i * 25)).save(img_dir / f"{name}.jpg")
        Image.new("RGB", (128, 72), (i * 40, 10, 200)).save(seg_dir / f"{name}.png")
        frames.append(dict(name=f"{name}.jpg", labels=[
            dict(id="17", category="car", attributes=dict(truncated=False, occluded=True),
                 box2d=dict(x1=100.0 + 40 * i, y1=120.0, x2=600.0, y2=500.0)),
            dict(id="4", category="sky", attributes={}, box2d=dict(x1=0, y1=0, x2=1, y2=1)),
            dict(id="23", category="pedestrian", attributes={},
                 box2d=dict(x1=900.0, y1=200.0, x2=1000.0 - 10 * i, y2=650.0)),
        ]))
    (lbl_dir / f"{CLIP_ID}.json").write_text(json.dumps(frames))


@pytest.mark.parametrize("use_segmentation", [False, True])
def test_bdd100k_samples_equal_jax(tmp_path, use_segmentation):
    _make_bdd100k(tmp_path)
    ours, ref = _both("bdd100k", str(tmp_path), if_last_frame_traj=True,
                      use_segmentation=use_segmentation)
    assert ours.if_last_frame_trajectory and ours.fps == 5
    assert len(ours) == len(ref) == 3
    _assert_samples_equal(ours[2], ref[2], trajectory=True)


def test_collate_equals_jax(tmp_path):
    _make_kitti(tmp_path, n=6)
    for name, root in (("synthetic", "."), ("kitti", str(tmp_path))):
        ours, ref = _both(name, root)
        out = collate_clip_batch([ours[0], ours[1]])
        exp = jax_collate([ref[0], ref[1]])
        assert sorted(out) == sorted(exp), name
        assert out["indices"] == exp["indices"] and out["prompts"] == exp["prompts"]
        for key in ("clips", "bbox_images", "cam_to_img"):
            assert (key in out) == (key in exp), (name, key)
            if key in exp:
                assert isinstance(out[key], torch.Tensor)
                np.testing.assert_array_equal(out[key].numpy(), exp[key], err_msg=key)
        assert sorted(out["objects"]) == sorted(exp["objects"])
        for k, v in exp["objects"].items():
            assert out["objects"][k].numpy().dtype == v.dtype, k
            np.testing.assert_array_equal(out["objects"][k].numpy(), v, err_msg=k)


def _make_davis(root, n=6, split_file=True):
    """The DAVIS tree of tests/test_datasets_fixtures.py: two objects whose
    masks move across ``n`` frames, and a second sequence without masks."""
    for seq in ("bear", "boat"):
        img_dir = root / "DAVIS/JPEGImages/480p" / seq
        img_dir.mkdir(parents=True)
        for i in range(n):
            Image.new("RGB", (96, 54), (10, 120 + 10 * i, 60)).save(img_dir / f"{i:05d}.jpg")
    ann_dir = root / "DAVIS/Annotations/480p/bear"
    ann_dir.mkdir(parents=True)
    for i in range(n):
        mask = np.zeros((54, 96), np.uint8)
        mask[10:30, 20 + i: 50 + i] = 1  # object 1 moves right
        mask[35:45, 5:25] = 2
        Image.fromarray(mask, mode="L").save(ann_dir / f"{i:05d}.png")
    if split_file:
        sets_dir = root / "DAVIS/ImageSets/2017"
        sets_dir.mkdir(parents=True)
        (sets_dir / "train.txt").write_text("bear\n")
        (sets_dir / "val.txt").write_text("boat\nbear\n")


@pytest.mark.parametrize("mode", ["train", "val", "image", "no_split_file"])
def test_davis_samples_equal_jax(tmp_path, mode):
    from ctrlv_tpu.data.davis import masks_to_boxes as jax_masks_to_boxes
    from ctrlv_tpu_torch.data import DAVISDataset
    from ctrlv_tpu_torch.data.davis import masks_to_boxes

    _make_davis(tmp_path, split_file=mode != "no_split_file")
    kw = dict(if_train=mode != "val", data_type="image" if mode == "image" else "clip",
              non_overlapping_clips=mode == "val")
    ours, ref = _both("davis", str(tmp_path), **kw)
    assert isinstance(ours, DAVISDataset) and len(ours) == len(ref) > 0
    assert ours.image_list == ref.image_list and ours.clip_list == ref.clip_list
    for i in range(len(ref)):
        out, exp = ours[i], ref[i]
        if mode == "image":
            np.testing.assert_array_equal(out["clip"], exp["clip"])
            assert out["labels"] == exp["labels"] and out["bbox_images"] is None
        else:
            _assert_samples_equal(out, exp, trajectory=False)
    assert ours.get_labels_by_index(0, 0) == ref.get_labels_by_index(0, 0)
    rng = np.random.default_rng(2)
    for _ in range(5):
        mask = rng.integers(0, 4, (12, 17)) * (rng.random((12, 17)) < 0.3)
        assert masks_to_boxes(mask) == jax_masks_to_boxes(mask)


@pytest.mark.parametrize("seed", [0, 1])
def test_loader_order_equals_jax(seed):
    kw = dict(if_train=True, batch_size=2, clip_length=1, shuffle=True, train_H=8, train_W=8,
              seed=seed, num_clips=7)
    _, ours = get_dataloader(".", "synthetic", **kw)
    _, ref = jax_get_dataloader(".", "synthetic", prefetch=0, **kw)
    assert len(ours) == len(ref) == 3  # drop-last
    for _epoch in range(2):
        got = [b["indices"] for b in ours]
        assert got == [b["indices"] for b in ref]
    assert got != list(range(6))  # shuffled


def test_workers_yield_the_same_batches():
    kw = dict(if_train=False, batch_size=2, clip_length=2, shuffle=False, train_H=H, train_W=W,
              if_return_bbox_im=True, num_clips=4)
    batches = [list(get_dataloader(".", "synthetic", num_workers=n, **kw)[1]) for n in (0, 2)]
    assert len(batches[0]) == len(batches[1]) == 2
    for a, b in zip(*batches):
        assert a["indices"] == b["indices"]
        for key in ("clips", "bbox_images", "cam_to_img"):
            assert torch.equal(a[key], b[key]), key
        for k in a["objects"]:
            assert torch.equal(a["objects"][k], b["objects"][k]), k
