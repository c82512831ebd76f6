"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

The sources in ``ctrlv_tpu_torch/csrc`` compile, at first use, into one
shared library with a plain C interface under ``build/kernels/<digest>/``
at the repository root (git-ignored). The digest covers the sources and the
flags, so an edited source builds anew and an unchanged one loads the
library already built. A failed build raises; nothing falls back. Each
source is compiled by an nvcc of its own, all started together, and the
objects are then linked:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas -v -c -o x.o csrc/x.cu      (one per source)
    nvcc -shared -o libctrlv_kernels.so *.o

``-Xptxas -v`` makes ptxas report each kernel's registers, shared memory
and spills; the report is kept in ``nvcc.log`` beside the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libctrlv_kernels.so"

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry points, each (tensors..., shape ints..., scalar, stream) -> cudaError_t
_SIGNATURES = {
    # q, k, v, out, batch, sq, sk, heads, head_dim, scale
    "ctrlv_mha_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    "ctrlv_flash_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    # q, k, v, out, n, frames, heads, head_dim, scale
    "ctrlv_small_mha_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    # q, k, v, out, batch, frames, s, heads, head_dim, scale
    "ctrlv_small_mha_fm_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    # x, gamma, beta, out, scratch, runs, run, spatial, channels per group, groups, splits,
    # params are bf16, silu, eps
    "ctrlv_group_norm_fwd": (_P, _P, _P, _P, _P, _L, _L, _L, _I, _I, _I, _I, _I, _F, _P),
    # x, gamma, beta, out, rows, width, params are bf16, eps
    "ctrlv_layer_norm_fwd": (_P, _P, _P, _P, _I, _I, _I, _F, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_info: dict = {}  # {"seconds", "built", "path", "log"} of the library in use


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the kernels cannot be built")


def _compile(out_dir: Path) -> tuple[Path, str]:
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / LIB_NAME
    tag = os.getpid()
    nvcc = _nvcc()
    units = [p for p in _sources() if p.suffix == ".cu"]
    objects = [out_dir / f".{p.stem}.{tag}.o" for p in units]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)] for p, o in zip(units, objects)]
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    log, failed = "", []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        log += " ".join(cmd) + "\n" + out
        if proc.returncode != 0:
            failed.append(proc.returncode)
    tmp = out_dir / f".{LIB_NAME}.{tag}"
    if not failed:
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objects)]
        proc = subprocess.run(link, capture_output=True, text=True)
        log += " ".join(link) + "\n" + proc.stdout + proc.stderr
        if proc.returncode != 0:
            failed.append(proc.returncode)
    for o in objects:
        o.unlink(missing_ok=True)
    (out_dir / "nvcc.log").write_text(log)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {failed[0]}):\n{log}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib, log


def load() -> ctypes.CDLL:
    """The kernel library, built on first use in this checkout."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out_dir = BUILD_ROOT / _digest()
        path = out_dir / LIB_NAME
        t0 = time.perf_counter()
        built = not path.is_file()
        if built:
            path, log = _compile(out_dir)
        else:
            log_file = out_dir / "nvcc.log"
            log = log_file.read_text() if log_file.is_file() else ""
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        build_info.update(
            seconds=time.perf_counter() - t0, built=built, path=str(path), log=log
        )
        _lib = lib
        return lib
