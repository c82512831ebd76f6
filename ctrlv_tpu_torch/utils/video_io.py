"""Host-side video and image export (PIL; no cv2).

The port's copy of ``ctrlv_tpu/utils/video_io.py`` (the reference's
``export_to_video``, ``utils/plotting.py:182-195``, writes mp4 through cv2):
clips export as animated GIFs, through imageio where it is importable and
PIL otherwise. Both are imported when a function runs, not with the module.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


def export_to_video(
    video_frames: List[np.ndarray], output_path: Optional[str] = None, fps: int = 5
) -> str:
    """frames: list of (H, W, 3) uint8 arrays."""
    if output_path is None:
        import tempfile

        output_path = tempfile.NamedTemporaryFile(suffix=".gif", delete=False).name
    try:
        import imageio

        imageio.mimsave(output_path, video_frames, fps=fps)
        return output_path
    except ImportError:
        pass
    from PIL import Image

    if output_path.endswith(".mp4"):
        output_path = output_path[:-4] + ".gif"
    images = [Image.fromarray(np.asarray(f, np.uint8)) for f in video_frames]
    images[0].save(
        output_path,
        save_all=True,
        append_images=images[1:],
        duration=int(1000 / fps),
        loop=0,
    )
    return output_path


def export_to_frames(video_frames: List[np.ndarray], out_dir: str) -> str:
    """Bit-exact PNG-sequence export (a GIF merges identical consecutive
    frames, so round-trip consumers such as offline metrics use this)."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    for i, f in enumerate(video_frames):
        Image.fromarray(np.asarray(f, np.uint8)).save(
            os.path.join(out_dir, f"frame_{i:05d}.png")
        )
    return out_dir


def load_video(path: str) -> np.ndarray:
    """Animated GIF or PNG-sequence directory -> (F, H, W, 3) uint8."""
    from PIL import Image, ImageSequence

    if os.path.isdir(path):
        files = sorted(
            f for f in os.listdir(path) if f.endswith((".png", ".jpg"))
        )
        return np.stack(
            [np.asarray(Image.open(os.path.join(path, f)).convert("RGB")) for f in files]
        )
    img = Image.open(path)
    frames = [
        np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(img)
    ]
    return np.stack(frames)


def frames_to_uint8(frames01: np.ndarray) -> List[np.ndarray]:
    """[0,1] float (F,H,W,3) -> list of uint8 frames."""
    arr = (np.clip(np.asarray(frames01), 0, 1) * 255).astype(np.uint8)
    return [arr[i] for i in range(arr.shape[0])]
