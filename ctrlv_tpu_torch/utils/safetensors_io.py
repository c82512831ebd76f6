"""The safetensors file format, read and written with torch alone.

A file is an 8-byte little-endian header length, a JSON header padded with
spaces to a multiple of 8 bytes, then the tensors' raw little-endian bytes.
The header maps each name to ``{"dtype", "shape", "data_offsets"}`` (offsets
into the byte buffer after the header) and may hold string metadata under
``"__metadata__"``. This is the layout that diffusers and transformers
checkpoints use; files written here load with the ``safetensors`` package
and the other way round.

Reading maps the file and views each tensor with ``torch.frombuffer`` (numpy
has no bf16), then copies it to the device asked for.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import sys
from typing import Dict, Iterator, Mapping, Optional, Tuple

import torch

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16, "I64": torch.int64}
_NAMES = {v: k for k, v in DTYPES.items()}
_MAX_HEADER = 100 * 2**20

if sys.byteorder != "little":
    raise ImportError("safetensors_io reads and writes little-endian bytes in place")


def _read_header(f) -> Tuple[dict, int]:
    """The header and the file offset where the tensors' bytes start."""
    head = f.read(8)
    if len(head) != 8:
        raise ValueError(f"{f.name}: too short for a safetensors file")
    (n,) = struct.unpack("<Q", head)
    if n > _MAX_HEADER:
        raise ValueError(f"{f.name}: header of {n} bytes")
    header = json.loads(f.read(n))
    if not isinstance(header, dict):
        raise ValueError(f"{f.name}: the header is not a JSON object")
    return header, 8 + n


def iter_tensors(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) in the header's order, each a CPU view of a private
    (copy-on-write) map of the file; the map lives as long as a view does."""
    with open(path, "rb") as f:
        header, start = _read_header(f)
        size = os.fstat(f.fileno()).st_size
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size > start else None
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}; read are {sorted(DTYPES)}")
        shape = tuple(int(s) for s in info["shape"])
        begin, end = (int(o) for o in info["data_offsets"])
        numel = 1
        for s in shape:
            numel *= s
        if end - begin != numel * dtype.itemsize or begin < 0 or start + end > size:
            raise ValueError(f"{path}: {name} has offsets {begin}:{end} for {shape} {dtype}")
        if numel == 0:
            yield name, torch.empty(shape, dtype=dtype)
            continue
        yield name, torch.frombuffer(buf, dtype=dtype, count=numel, offset=start + begin).view(shape)


def load_file(path: str, device=None) -> Dict[str, torch.Tensor]:
    """Every tensor of the file, each copied to ``device`` (the CPU when
    None) into memory of its own."""
    device = torch.device("cpu") if device is None else torch.device(device)
    return {name: t.to(device, copy=True) for name, t in iter_tensors(path)}


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (on any device) to ``path``. The bytes go in order of
    element size, largest first, then by name, so every tensor starts at an
    offset aligned to its element size."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: Dict[str, object] = {}
    if metadata:
        if not all(isinstance(k, str) and isinstance(v, str) for k, v in metadata.items()):
            raise TypeError("safetensors metadata maps strings to strings")
        header["__metadata__"] = dict(metadata)
    offset = 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise TypeError(f"{name}: dtype {t.dtype}; written are {sorted(_NAMES.values(), key=str)}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            t = tensors[name].detach().to("cpu").contiguous().reshape(-1)
            if t.numel():
                f.write(t.view(torch.uint8).numpy().data)
