"""The port's nuScenes data path against the JAX package's, on the CPU.

On the nuScenes trees of tests/test_nuscenes_native.py (``_build_dataroot``:
two scenes of CAM_FRONT frames, keyframes at 2 Hz with 12 Hz sweeps between
them, a car, a traffic cone and a pedestrian), every result is bit-equal:
the quaternions, boxes and tables; the projection, hull and clip math and
the 7 Hz resampling; clips in train, val and image modes with their labels
and their conditioning frames (both packages draw them with the native
rasterizer), with and without 3D wireframes; the frames' PNG cache; and
``build_dataset``. Through ``get_dataloader`` with two ``spawn`` workers and
no shuffle, the batches equal the JAX dataset's items read in order, track
ids and fill colours included; shuffled, each worker numbers the tracks in
its own read order (ROADMAP §3).
"""

import json
import math
import os

import numpy as np
import pytest

from ctrlv_tpu.data import collate_clip_batch as jax_collate
from ctrlv_tpu.data import nuscenes as jax_nusc
from ctrlv_tpu.data import nuscenes_tables as jax_tables
from ctrlv_tpu.data.loader import build_dataset as jax_build_dataset
from ctrlv_tpu_torch.data import NuScenesDataset, build_dataset, get_dataloader
from ctrlv_tpu_torch.data import native
from ctrlv_tpu_torch.data import nuscenes as nusc
from ctrlv_tpu_torch.data import nuscenes_tables as tables
from test_nuscenes_native import _build_dataroot
from test_torch_data import _assert_samples_equal

H, W = 32, 64


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The test tree, with the scene that has objects in both splits."""
    root = _build_dataroot(tmp_path_factory.mktemp("nusc"))
    splits = os.path.join(root, "nuscenes", "v1.0-trainval", "splits.json")
    with open(splits, "w") as f:
        json.dump({"train": ["scene-0001"], "val": ["scene-0001", "scene-0002"], "test": []}, f)
    return root


def _quats(rng, n):
    qs = [rng.standard_normal(4) for _ in range(n)]
    qs.append(np.array([1.0, 0.0, 0.0, 0.0]))
    qs.append(np.array([math.cos(3 * math.pi / 4), 0.0, 0.0, math.sin(3 * math.pi / 4)]))
    return qs


def test_quaternions_and_boxes_equal_jax():
    rng = np.random.default_rng(0)
    qs = _quats(rng, 12)
    for a, b in zip(qs, qs[1:] + qs[:1]):
        p, r = tables.Quaternion(a), jax_tables.Quaternion(a)
        pb, rb = tables.Quaternion(b), jax_tables.Quaternion(b)
        for name in ("rotation_matrix", "axis"):
            np.testing.assert_array_equal(getattr(p, name), getattr(r, name))
        assert p.angle == r.angle and p.radians == r.radians
        assert p.yaw_pitch_roll == r.yaw_pitch_roll
        np.testing.assert_array_equal(p.inverse.q, r.inverse.q)
        np.testing.assert_array_equal((p * pb).q, (r * rb).q)
        v = rng.standard_normal(3)
        np.testing.assert_array_equal(p.rotate(v), r.rotate(v))
        # a near-parallel pair takes the lerp branch, an opposite one flips a sign
        for other in (b, a + 1e-3 * rng.standard_normal(4), -a):
            for t in (-0.5, 0.0, 0.3, 1.0):
                np.testing.assert_array_equal(
                    tables.Quaternion.slerp(p, tables.Quaternion(other), t).q,
                    jax_tables.Quaternion.slerp(r, jax_tables.Quaternion(other), t).q)
        center, wlh = rng.uniform(-5, 5, 3), rng.uniform(0.5, 4, 3)
        box, ref = tables.Box(center, wlh, p), jax_tables.Box(center, wlh, r)
        box.translate(-center / 3)
        ref.translate(-center / 3)
        box.rotate(pb)
        ref.rotate(rb)
        np.testing.assert_array_equal(box.corners(), ref.corners())
        np.testing.assert_array_equal(box.corners(1.5), ref.corners(1.5))


def test_tables_and_splits_equal_jax(root, tmp_path):
    dataroot = os.path.join(root, "nuscenes")
    ours, ref = tables.NuScenesTables(dataroot), jax_tables.NuScenesTables(dataroot)
    assert ours.scene == ref.scene
    for name in jax_tables._TABLES:
        assert ours._tables[name] == ref._tables[name], name
    n_boxes = 0
    for sd in ref._tables["sample_data"]:
        got, want = ours.get_boxes(sd["token"]), ref.get_boxes(sd["token"])
        assert len(got) == len(want)
        n_boxes += len(want)
        for g, w in zip(got, want):
            assert (g.name, g.token) == (w.name, w.token)
            np.testing.assert_array_equal(g.center, w.center)
            np.testing.assert_array_equal(g.wlh, w.wlh)
            np.testing.assert_array_equal(g.orientation.q, w.orientation.q)
    assert n_boxes > 0
    for split in ("train", "val", "test"):
        assert (tables.split_scene_names(dataroot, "v1.0-trainval", split, ours.scene)
                == jax_tables.split_scene_names(dataroot, "v1.0-trainval", split, ref.scene))
    # without splits.json: the name-sorted fallback
    names = [dict(name=f"scene-{i:04d}") for i in (7, 3, 9, 1, 5, 2, 8)]
    for split in ("train", "val", "test"):
        assert (tables.split_scene_names(str(tmp_path), "v1.0-trainval", split, names)
                == jax_tables.split_scene_names(str(tmp_path), "v1.0-trainval", split, names))
    with pytest.raises(FileNotFoundError, match="v1.0-mini"):
        tables.NuScenesTables(dataroot, "v1.0-mini")


def test_projection_math_equal_jax():
    rng = np.random.default_rng(1)
    intrinsic = np.array([[1266.4, 0.0, 816.3], [0.0, 1266.4, 491.5], [0.0, 0.0, 1.0]])
    stamps = np.cumsum(rng.uniform(0.07, 0.1, 60))
    for fps in (7.0, 2.0, 12.0):
        assert nusc.resample_by_timestamps(stamps, fps) == jax_nusc.resample_by_timestamps(
            stamps, fps)
    for i in range(40):
        box = tables.Box(rng.uniform([-15, -3, -5], [15, 3, 40]), rng.uniform(0.4, 6, 3),
                         tables.Quaternion(rng.standard_normal(4)))
        c3d = box.corners()
        np.testing.assert_array_equal(nusc.view_points(c3d, intrinsic),
                                      jax_nusc.view_points(c3d, intrinsic))
        for level in ("any", "all"):
            assert nusc.box_in_image(c3d, intrinsic, vis_level=level) == jax_nusc.box_in_image(
                c3d, intrinsic, vis_level=level)
        assert nusc.project_box_to_2d(c3d, intrinsic) == jax_nusc.project_box_to_2d(
            c3d, intrinsic)
        pts = rng.uniform(-400, 2000, (int(rng.integers(1, 9)), 2))
        if i % 5 == 0:
            pts[1:] = pts[0]  # degenerate: one point repeated
        np.testing.assert_array_equal(nusc._convex_hull(pts), jax_nusc._convex_hull(pts))
        np.testing.assert_array_equal(nusc._clip_polygon(pts, 1600.0, 900.0),
                                      jax_nusc._clip_polygon(pts, 1600.0, 900.0))
        assert nusc.post_process_coords(pts) == jax_nusc.post_process_coords(pts)
    assert nusc.NUSC_CLASS_TO_GROUP_IDS == jax_nusc.NUSC_CLASS_TO_GROUP_IDS
    assert nusc.NUSC_CLASS_TO_GROUP_IDS_KITTI == jax_nusc.NUSC_CLASS_TO_GROUP_IDS_KITTI


@pytest.mark.parametrize("show_3d", [False, True])
def test_native_frames_equal_jax(show_3d):
    """The 3D-style frame and the conditioning frame over a background, from
    the port's binding and the JAX package's, are the same bits."""
    from ctrlv_tpu.data import native as jax_native

    rng = np.random.default_rng(2)
    n, h, w = 5, 40, 72
    corners = rng.uniform(-10, 80, (n, 8, 2)).astype(np.float32)
    valid = np.arange(n) < 4
    outline, fill = rng.random((n, 3)).astype(np.float32), rng.random((n, 3)).astype(np.float32)
    background = rng.random((h, w, 3)).astype(np.float32)
    before = background.copy()
    for bg in (None, background):
        for hw in ((None, None), (2.0, 0.8)):
            got = native.rasterize_frame_3dstyle_native(
                corners, valid, outline, fill, h, w, show_3d=show_3d, background=bg,
                hw2=hw[0], hw1=hw[1])
            want = jax_native.rasterize_frame_3dstyle_native(
                corners, valid, outline, fill, h, w, show_3d=show_3d, background=bg,
                hw2=hw[0], hw1=hw[1])
            np.testing.assert_array_equal(got, want)
            assert (got != (0 if bg is None else bg)).any()
        bbox = np.concatenate([corners.min(1), corners.max(1)], -1)
        got = native.rasterize_frame_native(corners, bbox, valid, outline, fill, h, w,
                                            background=bg, plot_2d_bbox=show_3d)
        want = jax_native.rasterize_frame_native(corners, bbox, valid, outline, fill, h, w,
                                                 background=bg, plot_2d_bbox=show_3d)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(background, before)  # drawn on a copy


def _both(root, **kw):
    kw = dict(dict(if_train=True, clip_length=4, if_return_bbox_im=True, train_H=H, train_W=W),
              **kw)
    return build_dataset("nuscenes", root, **kw), jax_build_dataset("nuscenes", root, **kw)


@pytest.mark.parametrize("mode", ["train", "val", "image", "train_3d"])
def test_samples_equal_jax(root, mode):
    kw = dict(if_train=mode != "val", data_type="image" if mode == "image" else "clip")
    ours, ref = _both(root, **kw)
    if mode == "train_3d":
        ours.if_3d = ref.if_3d = True
    assert isinstance(ours, NuScenesDataset) and len(ours) == len(ref) > 0
    assert ours.num_frames_total() == ref.num_frames_total()
    assert ours.clip_starts == ref.clip_starts and ours.image_tokens == ref.image_tokens
    for i in range(len(ref)):  # in order: the track ids are numbered as they come
        out, exp = ours[i], ref[i]
        assert ours.get_frame_file_by_index(i, 0) == ref.get_frame_file_by_index(i, 0)
        if mode == "image":
            assert sorted(out) == sorted(exp) and out["bbox_images"] is None
            np.testing.assert_array_equal(out["clip"], exp["clip"])
            assert out["labels"] == exp["labels"]
        else:
            _assert_samples_equal(out, exp, trajectory=False)
    # image mode draws nothing, so it never meets the cone
    assert ours.TRACKID_LOOKUP == ref.TRACKID_LOOKUP
    assert len(ref.TRACKID_LOOKUP) == (2 if mode == "image" else 3)
    if mode != "image":
        assert (out["bbox_images"] > -1).any()
    if mode == "train_3d":  # wireframes change the frame
        plain = _both(root)[0]
        assert not np.array_equal(plain[0]["bbox_images"], ours[0]["bbox_images"])


def test_bbox_png_cache_equals_jax(root, tmp_path):
    ours, ref = _both(root, bbox_dir=str(tmp_path / "port"))
    ref.bbox_dir = str(tmp_path / "jax")
    _assert_samples_equal(ours[1], ref[1], trajectory=False)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 4
    from PIL import Image

    for name in names:
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port" / name)),
                                      np.asarray(Image.open(tmp_path / "jax" / name)))
    assert ours.get_bbox_image_file_by_index(1) == os.path.join(
        str(tmp_path / "port"), f"{ours._token_at(1, 0)}.png")
    again = ours.load_bbox_frame(1, 0, None, None)  # served from the cache
    np.testing.assert_array_equal(again, ours[1]["bbox_images"][0])


def test_the_renderer_raises_without_the_native_library(root, monkeypatch):
    """No numpy fallback: where the library cannot be loaded, drawing raises."""
    ours, _ = _both(root)

    def unavailable():
        raise RuntimeError("cannot build the native rasterizer: make not found")

    monkeypatch.setattr(native, "load_native", unavailable)
    with pytest.raises(RuntimeError, match="native rasterizer"):
        ours.render_nusc_bbox_frame(ours._token_at(0, 0))
    with pytest.raises(FileNotFoundError, match="v1.0-test"):
        build_dataset("nuscenes", root, if_train=True, clip_length=4, test_split=True)


def _collated_in_order(root, order, **kw):
    """The JAX dataset's items read in ``order`` by one object, collated one
    by one."""
    ref = _both(root, **kw)[1]
    return {i: jax_collate([ref[i]]) for i in order}


def _assert_batch_equal(got, want):
    assert got["indices"] == want["indices"]
    np.testing.assert_array_equal(got["clips"].numpy(), want["clips"])
    np.testing.assert_array_equal(got["bbox_images"].numpy(), want["bbox_images"])
    for k, v in want["objects"].items():
        np.testing.assert_array_equal(got["objects"][k].numpy(), v, err_msg=k)


def test_loader_workers_number_tracks_as_jax(root):
    """Two spawn workers, no shuffle: each batch equals the JAX dataset's item
    read in order, track ids and fill colours included. Shuffled (seed 0),
    each worker numbers the tracks in its own read order: batch k comes from
    worker k % 2, which read the batches k - 2, k - 4, ... before it (seed 1
    reads 3, 2, 0, 1)."""
    kw = dict(if_train=True, batch_size=1, clip_length=4, if_return_bbox_im=True,
              train_H=H, train_W=W, num_workers=2)
    ds, loader = get_dataloader(root, "nuscenes", shuffle=False, **kw)
    assert ds.tracks_in_index_order
    want = _collated_in_order(root, range(len(ds)))
    batches = list(loader)
    assert len(batches) == len(ds) == 4
    for got in batches:
        _assert_batch_equal(got, want[got["indices"][0]])
    # read alone, item 1 numbers the pedestrian before the cone: the order matters
    alone = _collated_in_order(root, [1])[1]
    assert not np.array_equal(alone["objects"]["track_id"], want[1]["objects"]["track_id"])

    ds, loader = get_dataloader(root, "nuscenes", shuffle=True, seed=1, **kw)
    assert not ds.tracks_in_index_order
    batches = list(loader)
    order = [b["indices"][0] for b in batches]
    assert order == [3, 2, 0, 1]
    for k, got in enumerate(batches):
        reads = order[k % 2:k + 1:2]  # this worker's reads so far
        _assert_batch_equal(got, _collated_in_order(root, reads)[order[k]])
    assert not np.array_equal(batches[0]["objects"]["track_id"], want[3]["objects"]["track_id"])
