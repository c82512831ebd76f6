"""A/B of design variants of ``csrc/resblock.cu`` (K7) on one card.

    python3 -m ctrlv_tpu_torch.tools.ab_resblock

Each variant is a copy of ``ctrlv_tpu_torch/csrc`` in which ``resblock.cu``
is patched by exact string replacements and built apart under
``build/ab/<name>/`` (``ab_mha.build``): the source as it stands; with 160
output channels a block at every shape; with one producer warpgroup (three staging warps) instead of two; with the staging
loads not batched; with two weight stages in flight instead of up to four.

Every variant is held against the plain version at ragged shapes and at the
deepest level (and two runs against each other, to the bit); then each timed
shape runs through all variants in turns beside the unfused library chain
(``F.group_norm``, ``F.silu``, ``F.conv2d``), by CUDA events (median of 7
timings of 8 back-to-back calls). Prints the card's name and power limit
first. Needs the card and nvcc; exits non-zero if a variant fails to build
or disagrees with the plain version.
"""

from __future__ import annotations

import subprocess
import sys

import torch
import torch.nn.functional as F

from ctrlv_tpu_torch.ops import _build, resblock
from ctrlv_tpu_torch.tools.ab_mha import build, cuda_ms

TOL = 1e-2  # |kernel - plain| <= TOL * (1 + |plain|), as in chip_smoke.py
SPLIT = ("kHalves == 1 ? 96 : 40;", "kHalves == 1 ? 160 : 216;", "kHalves == 1 ? 4 : 1;")
VARIANTS = {  # name: (old, new) string replacements in resblock.cu
    "as built": [],
    "160 channels a block": [("for (int halves = 2; halves >= 1; --halves)",
                              "for (int halves = 1; halves >= 1; --halves)")],
    "one producer warpgroup": [("constexpr int kProducers = 2;", "constexpr int kProducers = 1;")],
    "320: 2 loads in flight, 56/200 registers": [
        (SPLIT[0], "kHalves == 1 ? 96 : 56;"), (SPLIT[1], "kHalves == 1 ? 160 : 200;"),
        (SPLIT[2], "kHalves == 1 ? 4 : 2;")],
    "160: 1 load in flight": [(SPLIT[2], "kHalves == 1 ? 1 : 1;")],
    "160: 2 loads in flight": [(SPLIT[2], "kHalves == 1 ? 2 : 1;")],
    "two weight stages": [("constexpr int kMaxStages = 4;", "constexpr int kMaxStages = 2;")],
    # Diagnostics, whose outputs are wrong: the time without one of the two feeds.
    "no staging (diagnostic)": [("for (int q0 = tt / 32; q0 < row_items;",
                                 "for (int q0 = tt / 32; q0 < 0;")],
    "no weight copies (diagnostic)": [("mbar_arrive_expect_tx(&full[s], kStage);",
                                       "mbar_arrive(&full[s]);\n    return;")],
    "no wait for the last tap (diagnostic)": [
        ("constexpr int kInFlight = kHalves == 1 ? 1 : 0;", "constexpr int kInFlight = 1;")],
    "no ldmatrix (diagnostic)": [("ldmatrix_x4(af[tap % kSets][kk], abuf + toff + kk * 16);",
                                  "af[tap % kSets][kk][0] = kk;")],
    "no epilogue stores (diagnostic)": [
        ("*reinterpret_cast<uint4*>(a.out + off[u]) = o;", "")],
}
DIAGNOSTIC = {name for name in VARIANTS if name.endswith("(diagnostic)")}
CHECKS = [(3, 320, 11, 16), (2, 320, 3, 8), (2, 1280, 5, 8), (4, 640, 20, 32),
          (250, 1280, 5, 8), (50, 320, 40, 64)]
TIMED = [(50, 320, 40, 64), (50, 640, 20, 32), (50, 1280, 10, 16), (50, 1280, 5, 8),
         (25, 1280, 5, 8), (250, 1280, 5, 8)]


def operands(n, c, h, w, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(shape, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(shape, generator=gen, device="cuda")).bfloat16()

    def weight():
        return draw((c, c, 3, 3), (9 * c) ** -0.5)

    return [draw((n, c, h, w), 1.5, 0.3), draw((c,), 0.2, 1.0), draw((c,), 0.1), weight(),
            draw((c,), 0.1), draw((n, c)), draw((c,), 0.2, 1.0), draw((c,), 0.1), weight(),
            draw((c,), 0.1)]


def library(x, g1, b1, w1, wb1, temb, g2, b2, w2, wb2):
    y = F.silu(F.group_norm(x, 32, g1, b1, 1e-5))
    y = F.conv2d(y, w1, wb1, padding=1) + temb[:, :, None, None]
    y = F.silu(F.group_norm(y, 32, g2, b2, 1e-5))
    return F.conv2d(y, w2, wb2, padding=1) + x


def main() -> None:
    if sys.argv[1:]:
        raise SystemExit(f"ab_resblock: takes no arguments, got {sys.argv[1:]}")
    if not torch.cuda.is_available():
        raise SystemExit("ab_resblock: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[ab] card {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    root = _build.BUILD_ROOT.parent / "ab"
    libs = {name: build(name, patches, root, "resblock.cu") for name, patches in VARIANTS.items()}
    fn = lambda ops: resblock.fused_resblock2d(*ops, 32, 1e-5)  # noqa: E731
    ok = True
    for name, lib in libs.items():
        _build._lib = lib
        for shape in CHECKS:
            ops = operands(*shape, seed=shape[2])
            out, again = fn(ops), fn(ops)
            ref = resblock.fused_resblock2d_plain(*ops, 32, 1e-5).float()
            diff = (out.float() - ref).abs()
            good = bool((diff <= TOL * (1 + ref.abs())).all()) and torch.equal(out, again)
            ok &= good or name in DIAGNOSTIC
            print(f"[ab] {name}: {shape}: max_abs_err {diff.max().item():.3e}, equal twice "
                  f"{torch.equal(out, again)}, ok {good}", flush=True)
    order = list(libs) + list(libs)[::-1]
    for shape in TIMED:
        ops = operands(*shape)
        times = {name: [] for name in libs}
        for name in order:
            _build._lib = libs[name]
            times[name].append(cuda_ms(lambda: fn(ops)))
        lib_ms = cuda_ms(lambda: library(*ops))
        print(f"[ab] {shape} ms: " + "; ".join(f"{n} {a:.4f} {b:.4f}" for n, (a, b) in times.items())
              + f"; library chain {lib_ms:.4f}", flush=True)
    if not ok:
        raise SystemExit("ab_resblock: a variant disagrees with the plain version")


if __name__ == "__main__":
    sys.exit(main())
