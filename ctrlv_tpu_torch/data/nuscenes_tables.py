"""nuScenes metadata without the nuscenes-devkit: tables, boxes, quaternions.

The port's own copy of ``ctrlv_tpu/data/nuscenes_tables.py``, with the same
arithmetic, so that every result is bit-equal to the JAX package's. The
reference (``datasets/nuscenes_.py:1-17,257-259``) uses the devkit and
``pyquaternion`` for four things, all table joins and quaternion math:

  - ``Quaternion``: a wxyz quaternion with ``rotation_matrix``, ``inverse``,
    ``radians``/``angle``, ``axis``, ``yaw_pitch_roll`` and ``slerp``
    (pyquaternion's conventions, its angle wrapping included);
  - ``Box``: centre, wlh and orientation, with ``translate``, ``rotate`` and
    ``corners()`` in the devkit's corner order (l along x, w along y, h
    along z);
  - ``NuScenesTables``: ``{dataroot}/{version}/*.json`` with the devkit's
    reverse indexes (``sample['data'][channel]``, ``sample['anns']``,
    ``category_name`` on each annotation) and ``get``/``get_box``/
    ``get_boxes``, whose sweeps between keyframes interpolate the centre
    linearly and the orientation by slerp (``NuScenes.get_boxes``);
  - ``split_scene_names``: the official splits from the devkit where it is
    installed, else a ``splits.json`` beside the tables, else a name-sorted
    fallback that is NOT the official split.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

_TABLES = (
    "scene",
    "sample",
    "sample_data",
    "ego_pose",
    "calibrated_sensor",
    "sensor",
    "sample_annotation",
    "instance",
    "category",
)


class Quaternion:
    """Minimal pyquaternion-compatible wxyz quaternion."""

    __slots__ = ("q",)

    def __init__(self, wxyz: Sequence[float]):
        if isinstance(wxyz, Quaternion):
            self.q = np.array(wxyz.q, dtype=np.float64)
        else:
            self.q = np.asarray(wxyz, dtype=np.float64).reshape(4).copy()

    def _normalised(self) -> np.ndarray:
        n = np.linalg.norm(self.q)
        return self.q / n if n > 0 else self.q

    @property
    def rotation_matrix(self) -> np.ndarray:
        w, x, y, z = self._normalised()
        return np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )

    @property
    def inverse(self) -> "Quaternion":
        w, x, y, z = self.q
        n2 = float(np.dot(self.q, self.q))
        return Quaternion(np.array([w, -x, -y, -z]) / n2)

    def __mul__(self, other: "Quaternion") -> "Quaternion":
        w1, x1, y1, z1 = self.q
        w2, x2, y2, z2 = other.q
        return Quaternion(
            [
                w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            ]
        )

    def rotate(self, v: np.ndarray) -> np.ndarray:
        return self.rotation_matrix @ np.asarray(v, dtype=np.float64)

    @property
    def angle(self) -> float:
        """Rotation angle in radians, wrapped to (-pi, pi] (pyquaternion)."""
        q = self._normalised()
        theta = 2.0 * math.atan2(float(np.linalg.norm(q[1:])), float(q[0]))
        wrapped = ((theta + math.pi) % (2 * math.pi)) - math.pi
        return math.pi if wrapped == -math.pi else wrapped

    # pyquaternion alias used by the reference (`orientation.radians`)
    radians = angle

    @property
    def axis(self) -> np.ndarray:
        q = self._normalised()
        n = float(np.linalg.norm(q[1:]))
        if n < 1e-12:
            return np.zeros(3)
        return q[1:] / n

    @property
    def yaw_pitch_roll(self):
        w, x, y, z = self._normalised()
        yaw = math.atan2(2 * (w * z - x * y), 1 - 2 * (y * y + z * z))
        pitch = math.asin(max(-1.0, min(1.0, 2 * (w * y + z * x))))
        roll = math.atan2(2 * (w * x - y * z), 1 - 2 * (x * x + y * y))
        return yaw, pitch, roll

    @staticmethod
    def slerp(q0: "Quaternion", q1: "Quaternion", amount: float) -> "Quaternion":
        a = q0._normalised().copy()
        b = q1._normalised()
        t = float(np.clip(amount, 0.0, 1.0))
        dot = float(np.dot(a, b))
        if dot < 0.0:
            a, dot = -a, -dot
        if dot > 0.9995:  # nearly parallel: lerp + renormalize
            out = a + t * (b - a)
            return Quaternion(out / np.linalg.norm(out))
        theta = math.acos(max(-1.0, min(1.0, dot))) * t
        ortho = b - a * dot
        ortho = ortho / np.linalg.norm(ortho)
        return Quaternion(a * math.cos(theta) + ortho * math.sin(theta))


class Box:
    """Devkit-convention 3D box: corners() puts l along x, w along y, h along z."""

    def __init__(
        self,
        center: Sequence[float],
        size_wlh: Sequence[float],
        orientation: Quaternion,
        name: str = "",
        token: str = "",
    ):
        self.center = np.asarray(center, dtype=np.float64).reshape(3).copy()
        self.wlh = np.asarray(size_wlh, dtype=np.float64).reshape(3).copy()
        self.orientation = Quaternion(orientation)
        self.name = name
        self.token = token

    def translate(self, v: np.ndarray) -> None:
        self.center = self.center + np.asarray(v, dtype=np.float64)

    def rotate(self, quaternion: Quaternion) -> None:
        self.center = quaternion.rotation_matrix @ self.center
        self.orientation = quaternion * self.orientation

    def corners(self, wlh_factor: float = 1.0) -> np.ndarray:
        w, l, h = self.wlh * wlh_factor
        x = l / 2 * np.array([1, 1, 1, 1, -1, -1, -1, -1], dtype=np.float64)
        y = w / 2 * np.array([1, -1, -1, 1, 1, -1, -1, 1], dtype=np.float64)
        z = h / 2 * np.array([1, 1, -1, -1, 1, 1, -1, -1], dtype=np.float64)
        corners = self.orientation.rotation_matrix @ np.vstack((x, y, z))
        return corners + self.center[:, None]


class NuScenesTables:
    """Relational nuScenes metadata with the devkit's reverse indexes."""

    def __init__(self, dataroot: str, version: str = "v1.0-trainval"):
        self.dataroot = dataroot
        self.version = version
        table_dir = os.path.join(dataroot, version)
        if not os.path.isdir(table_dir):
            raise FileNotFoundError(
                f"nuScenes table dir not found: {table_dir} (expected "
                f"{{dataroot}}/{{version}}/*.json per the public schema)"
            )
        self._tables: Dict[str, List[dict]] = {}
        self._index: Dict[str, Dict[str, dict]] = {}
        for name in _TABLES:
            path = os.path.join(table_dir, f"{name}.json")
            records = json.load(open(path)) if os.path.exists(path) else []
            self._tables[name] = records
            self._index[name] = {r["token"]: r for r in records}
        self._decorate()

    # -- devkit reverse indexes (NuScenes.__make_reverse_index__) --------
    def _decorate(self) -> None:
        for ann in self._tables["sample_annotation"]:
            inst = self._index["instance"].get(ann["instance_token"])
            if inst is not None:
                cat = self._index["category"].get(inst["category_token"])
                ann["category_name"] = cat["name"] if cat else ""
        for sd in self._tables["sample_data"]:
            cs = self._index["calibrated_sensor"].get(sd["calibrated_sensor_token"])
            sensor = self._index["sensor"].get(cs["sensor_token"]) if cs else None
            sd["channel"] = sensor["channel"] if sensor else ""
            sd["sensor_modality"] = sensor.get("modality", "") if sensor else ""
        for sample in self._tables["sample"]:
            sample["data"] = {}
            sample["anns"] = []
        for sd in self._tables["sample_data"]:
            if sd.get("is_key_frame"):
                sample = self._index["sample"].get(sd["sample_token"])
                if sample is not None:
                    sample["data"][sd["channel"]] = sd["token"]
        for ann in self._tables["sample_annotation"]:
            sample = self._index["sample"].get(ann["sample_token"])
            if sample is not None:
                sample["anns"].append(ann["token"])

    # -- devkit API surface used by the dataset --------------------------
    @property
    def scene(self) -> List[dict]:
        return self._tables["scene"]

    def get(self, table: str, token: str) -> dict:
        return self._index[table][token]

    def get_box(self, ann_token: str) -> Box:
        rec = self._index["sample_annotation"][ann_token]
        return Box(
            rec["translation"],
            rec["size"],
            Quaternion(rec["rotation"]),
            name=rec.get("category_name", ""),
            token=rec["token"],
        )

    def get_boxes(self, sample_data_token: str) -> List[Box]:
        """Boxes (global frame) for a sample_data record.

        Keyframes (and first-sample sweeps) return the sample's recorded
        annotations; other sweeps interpolate each instance between the
        previous and current keyframe (linear center, slerp orientation) —
        the nuscenes-devkit ``get_boxes`` algorithm.
        """
        sd = self._index["sample_data"][sample_data_token]
        curr = self._index["sample"][sd["sample_token"]]
        if sd.get("is_key_frame") or not curr.get("prev"):
            return [self.get_box(t) for t in curr["anns"]]

        prev = self._index["sample"][curr["prev"]]
        curr_anns = [self._index["sample_annotation"][t] for t in curr["anns"]]
        prev_by_inst = {
            self._index["sample_annotation"][t]["instance_token"]: self._index[
                "sample_annotation"
            ][t]
            for t in prev["anns"]
        }
        t0, t1 = float(prev["timestamp"]), float(curr["timestamp"])
        t = min(max(float(sd["timestamp"]), t0), t1)
        boxes = []
        for ann in curr_anns:
            prev_ann = prev_by_inst.get(ann["instance_token"])
            if prev_ann is None:
                boxes.append(self.get_box(ann["token"]))
                continue
            center = [
                np.interp(t, [t0, t1], [c0, c1])
                for c0, c1 in zip(prev_ann["translation"], ann["translation"])
            ]
            rotation = Quaternion.slerp(
                Quaternion(prev_ann["rotation"]),
                Quaternion(ann["rotation"]),
                amount=(t - t0) / (t1 - t0) if t1 > t0 else 0.0,
            )
            boxes.append(
                Box(
                    center,
                    ann["size"],
                    rotation,
                    name=ann.get("category_name", ""),
                    token=ann["token"],
                )
            )
        return boxes


def split_scene_names(
    dataroot: str,
    version: str,
    split: str,
    scenes: Optional[List[dict]] = None,
) -> List[str]:
    """Official scene-name split with graceful degradation.

    Priority: nuscenes-devkit ``create_splits_scenes`` (the official
    700/150/150 lists) > ``{dataroot}/{version}/splits.json`` (a user-
    provided ``{"train": [...], "val": [...], "test": [...]}``) >
    deterministic name-sorted 85/15 trainval fallback (NOT the official
    split; documented so eval numbers aren't silently non-comparable).
    """
    try:  # official lists ship with the devkit
        from nuscenes.utils.splits import create_splits_scenes

        return create_splits_scenes()[split]
    except ImportError:
        pass
    path = os.path.join(dataroot, version, "splits.json")
    if os.path.exists(path):
        return json.load(open(path))[split]
    names = sorted(s["name"] for s in (scenes or []))
    if split == "test":
        return names  # v1.0-test tables hold only test scenes
    cut = int(round(0.85 * len(names)))
    return names[:cut] if split == "train" else names[cut:]
