"""Training-state checkpoints: ``checkpoint-{step}`` directories, rotation,
asynchronous saves and resume from the latest.

Counterpart of ``ctrlv_tpu/train/checkpoints.py`` (Orbax's
``CheckpointManager``; the reference's accelerate ``save_state`` with
``checkpoints_total_limit`` and ``--resume_from_checkpoint latest``).

A checkpoint holds one tree of nested dictionaries (string keys) and lists
whose leaves are tensors, ints, floats, bools, strings or None, as the
port's ``TrainState.opt_state`` is. The tensors go into
``tensors.safetensors`` through ``utils/safetensors_io.py``, each under its
path in the tree; the tree's structure with every other leaf goes into
``tree.json`` beside it. Nothing is pickled. A tensor that the tree holds
twice (an f32 parameter is its own master) is written once, and comes back
as one tensor. The format is the port's own: it does not read Orbax
checkpoints, and Orbax does not read it.

A save copies every tensor to host memory first and writes the files in a
thread, as Orbax's asynchronous checkpointing does, so that the loop does
not wait on the disk; the next save, ``wait()`` and ``close()`` join that
thread and raise what it raised. A checkpoint is written under a temporary
name and renamed when complete, and only then are the oldest beyond
``max_to_keep`` deleted.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional

import torch

from ..utils.safetensors_io import load_file, save_file

_NAME = re.compile(r"checkpoint-(\d+)$")
_TENSOR = "__tensor__"


def _encode(tree, path: str, tensors: Dict[str, torch.Tensor], seen: Dict[int, str]):
    """The JSON skeleton of ``tree``; its tensors, copied to the host, into ``tensors``."""
    if isinstance(tree, torch.Tensor):
        if id(tree) not in seen:
            seen[id(tree)] = path
            tensors[path] = tree.detach().to("cpu", copy=True)
        return {_TENSOR: seen[id(tree)]}
    if isinstance(tree, dict):
        if not all(isinstance(k, str) and "/" not in k for k in tree):
            raise TypeError(f"{path or 'the tree'}: a checkpointed dictionary has string keys "
                            f"without '/'")
        return {k: _encode(v, f"{path}/{k}" if path else k, tensors, seen) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_encode(v, f"{path}/{i}", tensors, seen) for i, v in enumerate(tree)]
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    raise TypeError(f"{path}: cannot checkpoint a {type(tree).__name__}")


def _decode(skeleton, tensors: Dict[str, torch.Tensor], template, path: str):
    """The tree of ``skeleton``. With a template, each tensor is copied into
    the template's tensor at the same path, which the result then holds."""
    if isinstance(skeleton, dict) and set(skeleton) == {_TENSOR}:
        saved = tensors[skeleton[_TENSOR]]
        if template is None:
            return saved
        if not isinstance(template, torch.Tensor) or template.shape != saved.shape \
                or template.dtype != saved.dtype:
            raise ValueError(f"{path}: saved {saved.dtype} {tuple(saved.shape)} does not fit "
                             f"the template's {template!r:.80}")
        with torch.no_grad():
            template.copy_(saved)
        return template
    if isinstance(skeleton, dict):
        if template is not None and set(template) != set(skeleton):
            raise ValueError(f"{path or 'the tree'}: saved keys {sorted(skeleton)[:6]} differ "
                             f"from the template's {sorted(template)[:6]}")
        return {k: _decode(v, tensors, None if template is None else template[k], f"{path}/{k}")
                for k, v in skeleton.items()}
    if isinstance(skeleton, list):
        if template is not None and len(template) != len(skeleton):
            raise ValueError(f"{path}: {len(skeleton)} saved items, {len(template)} in the "
                             f"template")
        return [_decode(v, tensors, None if template is None else template[i], f"{path}/{i}")
                for i, v in enumerate(skeleton)]
    return skeleton


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: Optional[int] = None, async_save: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep, self.async_save = max_to_keep, async_save
        self._thread: Optional[threading.Thread] = None
        self._pending: Optional[int] = None
        self._error: Optional[BaseException] = None

    def all_steps(self):
        steps = [int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m]
        return sorted(steps + ([self._pending] if self._pending is not None else []))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any, wait: bool = False) -> bool:
        """Save ``tree`` as ``checkpoint-{step}``. A step at or below the
        latest saved one is not saved again (False), as in Orbax."""
        latest = self.latest_step()
        saved = latest is None or step > latest
        if saved:
            self.wait()
            tensors: Dict[str, torch.Tensor] = {}
            skeleton = _encode(tree, "", tensors, {})
            self._pending = int(step)
            if self.async_save:
                self._thread = threading.Thread(target=self._write, args=(step, skeleton, tensors),
                                                name=f"checkpoint-{step}", daemon=False)
                self._thread.start()
            else:
                self._write(step, skeleton, tensors)
        if wait:
            self.wait()
        return saved

    def _write(self, step: int, skeleton, tensors: Dict[str, torch.Tensor]) -> None:
        final = os.path.join(self.directory, f"checkpoint-{step}")
        tmp = final + ".tmp"
        try:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            save_file(tensors, os.path.join(tmp, "tensors.safetensors"))
            with open(os.path.join(tmp, "tree.json"), "w") as f:
                json.dump({"step": int(step), "tree": skeleton}, f)
            os.replace(tmp, final)
            if self.max_to_keep:
                steps = sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory))
                               if m)
                for old in steps[:-self.max_to_keep]:
                    shutil.rmtree(os.path.join(self.directory, f"checkpoint-{old}"))
        except Exception as exc:  # re-raised by wait()
            self._error = exc
        finally:
            self._pending = None

    def wait(self) -> None:
        """Join the save in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError("the checkpoint save failed") from error

    def restore(self, step: Optional[int] = None, template: Any = None) -> Any:
        """The tree of ``checkpoint-{step}``, the latest where ``step`` is
        None; None where there is none. Without ``template`` its tensors come
        back on the CPU; with it they are copied, to the bit, into the
        template's tensors (same paths, shapes and dtypes), which the
        returned tree holds."""
        self.wait()
        step = self.latest_step() if step is None else int(step)
        if step is None:
            return None
        ckpt = os.path.join(self.directory, f"checkpoint-{step}")
        with open(os.path.join(ckpt, "tree.json")) as f:
            skeleton = json.load(f)["tree"]
        tensors = load_file(os.path.join(ckpt, "tensors.safetensors"))
        return _decode(skeleton, tensors, template, "")

    def close(self) -> None:
        self.wait()
