"""ctypes binding of the native C++ rasterizer (``native/rasterizer.cpp``).

The port's own copy of ``ctrlv_tpu/data/native.py``, for the three functions
the data path draws with: the conditioning frame of 3D wireframes and 2D
boxes (on a background where one is given: the teaser's white canvas), the
nuScenes frame in the reference's ``my_render_3d_style``, and the trajectory
frame. The library is built with ``make -C
native`` (g++ only) when it is absent. Where it cannot be built or loaded,
``load_native`` raises: the port has no other rasterizer.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from ..ops.rasterize import _HW_3DSTYLE_1, _HW_3DSTYLE_2

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def native_dir() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native"
    )


def load_native() -> ctypes.CDLL:
    """The library, built first where it is absent; raises where it cannot
    be built or loaded."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so_path = os.path.join(native_dir(), "libctrlv_native.so")
        if not os.path.exists(so_path):
            try:
                subprocess.run(["make", "-C", native_dir()], check=True, capture_output=True,
                               text=True)
            except FileNotFoundError as e:
                raise RuntimeError(f"cannot build the native rasterizer: {e}") from e
            except subprocess.CalledProcessError as e:
                raise RuntimeError(
                    f"cannot build the native rasterizer:\n{e.stdout}{e.stderr}") from e
        lib = ctypes.CDLL(so_path)
        f32 = ctypes.POINTER(ctypes.c_float)
        u8 = ctypes.POINTER(ctypes.c_uint8)
        lib.rasterize_frame_native.argtypes = [
            f32, ctypes.c_int, ctypes.c_int, f32, f32, u8, f32, f32,
            ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ]
        lib.rasterize_frame_native.restype = None
        lib.rasterize_trajectory_native.argtypes = [
            f32, ctypes.c_int, ctypes.c_int, f32, u8, f32, f32,
            ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ]
        lib.rasterize_trajectory_native.restype = None
        lib.rasterize_frame_3dstyle_native.argtypes = [
            f32, ctypes.c_int, ctypes.c_int, f32, u8, f32, f32,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_float,
        ]
        lib.rasterize_frame_3dstyle_native.restype = None
        _LIB = lib
        return lib


def _f32(a: np.ndarray, shape) -> np.ndarray:
    a = np.ascontiguousarray(a, np.float32)
    if a.shape != shape:
        raise ValueError(f"expected an array of shape {shape}, got {a.shape}")
    return a


def _canvas(background: Optional[np.ndarray], height: int, width: int) -> np.ndarray:
    """A fresh (height, width, 3) float32 canvas: a copy of ``background``,
    else black."""
    if background is None:
        return np.zeros((height, width, 3), np.float32)
    return _f32(background, (height, width, 3)).copy()


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def rasterize_frame_native(
    corners: np.ndarray,  # (N, 8, 2)
    bbox2d: np.ndarray,  # (N, 4)
    valid: np.ndarray,  # (N,) bool
    type_color: np.ndarray,  # (N, 3)
    track_color: np.ndarray,  # (N, 3)
    height: int,
    width: int,
    background: Optional[np.ndarray] = None,
    plot_2d_bbox: bool = True,
    alpha_2dbbox: float = 0.75,
) -> np.ndarray:
    """One conditioning frame, (height, width, 3) float32 in [0, 1], drawn
    over a copy of ``background`` (black where it is None)."""
    lib = load_native()
    n = np.shape(corners)[0]
    corners, bbox2d = _f32(corners, (n, 8, 2)), _f32(bbox2d, (n, 4))
    type_color, track_color = _f32(type_color, (n, 3)), _f32(track_color, (n, 3))
    valid = np.ascontiguousarray(valid, np.uint8).reshape(n)
    img = _canvas(background, height, width)
    lib.rasterize_frame_native(
        _fptr(img), height, width, _fptr(corners), _fptr(bbox2d), _u8ptr(valid),
        _fptr(type_color), _fptr(track_color), n, int(plot_2d_bbox), float(alpha_2dbbox),
    )
    return img


def rasterize_frame_3dstyle_native(
    corners: np.ndarray,  # (N, 8, 2) canvas coords
    valid: np.ndarray,  # (N,) bool
    outline_color: np.ndarray,  # (N, 3)
    fill_color: np.ndarray,  # (N, 3)
    height: int,
    width: int,
    show_3d: bool = False,
    show_2d: bool = True,
    alpha: float = 0.75,
    background: Optional[np.ndarray] = None,
    hw2: Optional[float] = None,
    hw1: Optional[float] = None,
) -> np.ndarray:
    """One nuScenes frame as the reference's ``my_render_3d_style`` draws it,
    (height, width, 3) float32 in [0, 1]: each box's 2D extent filled with its
    fill colour at ``alpha`` (and, without ``show_3d``, its edge in the outline
    colour), then, with ``show_3d``, opaque wireframes of band half-widths
    ``hw2`` and ``hw1`` (pixels) over every fill."""
    lib = load_native()
    n = np.shape(corners)[0]
    corners = _f32(corners, (n, 8, 2))
    outline_color, fill_color = _f32(outline_color, (n, 3)), _f32(fill_color, (n, 3))
    valid = np.ascontiguousarray(valid, np.uint8).reshape(n)
    img = _canvas(background, height, width)
    lib.rasterize_frame_3dstyle_native(
        _fptr(img), height, width, _fptr(corners), _u8ptr(valid), _fptr(outline_color),
        _fptr(fill_color), n, int(show_3d), int(show_2d), float(alpha),
        float(_HW_3DSTYLE_2 if hw2 is None else hw2),
        float(_HW_3DSTYLE_1 if hw1 is None else hw1),
    )
    return img


def rasterize_trajectory_native(
    centers: np.ndarray,  # (N, 2)
    valid: np.ndarray,  # (N,) bool
    type_color: np.ndarray,  # (N, 3)
    track_color: np.ndarray,  # (N, 3)
    height: int,
    width: int,
    outer_radius: float = 20.0,
    inner_radius: float = 10.0,
) -> np.ndarray:
    """One trajectory frame: a track-colour disc with a type-colour disc
    inside it at each centre, (height, width, 3) float32 in [0, 1]."""
    lib = load_native()
    n = np.shape(centers)[0]
    centers = _f32(centers, (n, 2))
    type_color, track_color = _f32(type_color, (n, 3)), _f32(track_color, (n, 3))
    valid = np.ascontiguousarray(valid, np.uint8).reshape(n)
    img = np.zeros((height, width, 3), np.float32)
    lib.rasterize_trajectory_native(
        _fptr(img), height, width, _fptr(centers), _u8ptr(valid), _fptr(type_color),
        _fptr(track_color), n, float(outer_radius), float(inner_radius),
    )
    return img
