"""A/B of design variants of ``csrc/mha.cu`` (K1 and K8) on one card.

    python3 -m ctrlv_tpu_torch.tools.ab_mha

Each variant is a copy of ``ctrlv_tpu_torch/csrc`` in which ``mha.cu`` is
patched by exact string replacements, built apart under
``build/ab/<name>/``: the source as it stands, and the same without the
warpgroups' ping-pong; with K1 at head dim 64 on 128-row query tiles instead
of 192; with one block an item instead of the persistent grid; with K8 on
64-row tiles at every length.

Every variant is held against the plain version at ragged shapes (and two
runs against each other, to the bit); then each timed shape runs through all
variants in turns (forward, then backward) beside SDPA on a view, by CUDA
events (median of 7 timings of 8 back-to-back calls). Prints the card's name
and power limit first. Needs the card and nvcc; exits non-zero if a variant
fails to build or disagrees with the plain version.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from ctrlv_tpu_torch.ops import _build, attention, mha

TOL = 1e-2  # |kernel - plain| <= TOL * (1 + |plain|), as in chip_smoke.py
VARIANTS = {  # name: (old, new) string replacements in mha.cu
    "as built": [],
    "no ping-pong": [("constexpr bool kPingPong = kConsumers >= 2;",
                      "constexpr bool kPingPong = false;")],
    "K1 on 128 rows": [("if (!flash && head_dim == 64) return {192, 128, stages};",
                        "if (false) return {192, 128, stages};")],
    "a block an item": [("std::min<long long>(n_items, 1LL * sms * C::kMinBlocks)", "n_items")],
    "K8 on 64 rows": [("const int block = flash && tail >= 1 && tail <= 64 ? 64 : 128;",
                       "const int block = flash ? 64 : 128;")],
}
# (kind, shape, heads or None, keys): K1 over (B, S, H*D), K8 over (B, S, H, D)
CHECKS = [
    ("mha", (3, 1000, 320), 5, 1000), ("mha", (2, 1024, 320), 5, 2048),
    ("mha", (2, 1100, 256), 2, 1100), ("mha", (50, 2560, 320), 5, 2560),
    ("flash", (3, 160, 20, 64), None, 160), ("flash", (3, 192, 10, 64), None, 192),
    ("flash", (3, 200, 2, 128), None, 130), ("flash", (50, 640, 10, 64), None, 640),
]
TIMED = [
    ("mha", (50, 2560, 320), 5), ("mha", (250, 2560, 320), 5), ("mha", (25, 2560, 320), 5),
    ("flash", (50, 640, 10, 64), None), ("flash", (250, 640, 10, 64), None),
    ("flash", (50, 160, 20, 64), None), ("flash", (250, 160, 20, 64), None),
]


def build(name: str, patches, root: Path, source: str = "mha.cu"):
    """The kernel library with ``source`` patched, built under ``root``."""
    src = (_build.CSRC / source).read_text()
    for old, new in patches:
        if old not in src:
            raise SystemExit(f"ab: variant {name!r}: patch target not found in {source}: {old!r}")
        src = src.replace(old, new)
    tag = "".join(ch if ch.isalnum() else "_" for ch in name)
    csrc = root / tag / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(_build.CSRC, csrc)
    (csrc / source).write_text(src)
    keep = _build.CSRC, _build.BUILD_ROOT
    _build.CSRC, _build.BUILD_ROOT, _build._lib = csrc, root / tag / "build", None
    try:
        lib = _build.load()
    finally:
        _build.CSRC, _build.BUILD_ROOT = keep
    print(f"[ab] {name}: built in {_build.build_info['seconds']:.1f} s", flush=True)
    return lib


def operands(kind, shape, keys, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kv = (shape[0], keys) + tuple(shape[2:])
    def draw(s):
        return torch.randn(s, generator=gen, device="cuda", dtype=torch.bfloat16)

    return draw(shape), draw(kv), draw(kv)


def run(kind, shape, heads, q, k, v, plain=False):
    if kind == "mha":
        fn = mha.mha_attention_plain if plain else mha.mha_attention
        return fn(q, k, v, heads, (shape[2] // heads) ** -0.5)
    fn = attention.flash_attention_plain if plain else attention.flash_attention
    return fn(q, k, v, shape[3] ** -0.5)


def library(kind, shape, heads, q, k, v):
    if kind == "mha":
        d = shape[2] // heads
        view = lambda x: x.view(x.shape[0], x.shape[1], heads, d).transpose(1, 2)  # noqa: E731
    else:
        d = shape[3]
        view = lambda x: x.transpose(1, 2)  # noqa: E731
    return F.scaled_dot_product_attention(view(q), view(k), view(v), scale=d**-0.5)


def cuda_ms(fn, reps: int = 7, inner: int = 8) -> float:
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return sorted(times)[len(times) // 2]


def main() -> None:
    if sys.argv[1:]:
        raise SystemExit(f"ab_mha: takes no arguments, got {sys.argv[1:]}")
    if not torch.cuda.is_available():
        raise SystemExit("ab_mha: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[ab] card {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    root = _build.BUILD_ROOT.parent / "ab"
    libs = {name: build(name, patches, root) for name, patches in VARIANTS.items()}
    ok = True
    for name, lib in libs.items():
        _build._lib = lib
        for kind, shape, heads, keys in CHECKS:
            q, k, v = operands(kind, shape, keys, seed=shape[1])
            out = run(kind, shape, heads, q, k, v)
            again = run(kind, shape, heads, q, k, v)
            ref = run(kind, shape, heads, q, k, v, plain=True).float()
            diff = (out.float() - ref).abs()
            good = bool((diff <= TOL * (1 + ref.abs())).all()) and torch.equal(out, again)
            ok &= good
            print(f"[ab] {name}: {kind} {shape} keys {keys}: max_abs_err {diff.max().item():.3e}, "
                  f"equal twice {torch.equal(out, again)}, ok {good}", flush=True)
    order = list(libs) + list(libs)[::-1]
    for kind, shape, heads in TIMED:
        q, k, v = operands(kind, shape, shape[1])
        times = {name: [] for name in libs}
        for name in order:
            _build._lib = libs[name]
            times[name].append(cuda_ms(lambda: run(kind, shape, heads, q, k, v)))
        sdpa = cuda_ms(lambda: library(kind, shape, heads, q, k, v))
        print(f"[ab] {kind} {shape}" + (f"/{heads}" if heads else "") + " ms: "
              + "; ".join(f"{n} {a:.4f} {b:.4f}" for n, (a, b) in times.items())
              + f"; sdpa {sdpa:.4f}", flush=True)
    if not ok:
        raise SystemExit("ab_mha: a variant disagrees with the plain version")


if __name__ == "__main__":
    sys.exit(main())
