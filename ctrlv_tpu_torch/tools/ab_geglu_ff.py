"""A/B of design variants of ``csrc/geglu_ff.cu`` (K6) on one card.

    python3 -m ctrlv_tpu_torch.tools.ab_geglu_ff

Each variant is a copy of ``ctrlv_tpu_torch/csrc`` in which ``geglu_ff.cu``
is patched by exact string replacements and built apart under
``build/ab/<name>/`` (``ab_mha.build``): the source as it stands; without its
L2 cache hints; and, at C = 320, without the consumers' ping-pong, with a
wait for each K slab of the first product in a turn, with ten W1 stages and
one W2 stage. Diagnostics, whose outputs are wrong: without the weight
copies, without the epilogue's stores, without the gelu (act = a * g).

Every variant prints what ptxas reports for its K6 instantiations
(registers, spills, serialised wgmma), and is held against the plain version
at ragged shapes, both entries (and two runs against each other, to the
bit); then each timed shape runs through all variants in turns beside the
unfused library chain (``F.linear``, tanh gelu, mul, ``F.linear``), by CUDA
events (median of 7 timings of 8 back-to-back calls). Prints the card's name
and power limit first. Needs the card and nvcc; exits non-zero if a variant
fails to build or disagrees with the plain version.
"""

from __future__ import annotations

import subprocess
import sys

import torch

from ctrlv_tpu_torch.ops import _build, geglu_ff
from ctrlv_tpu_torch.tools.ab_mha import build, cuda_ms

TOL = 1e-2  # |kernel - plain| <= TOL * (1 + |plain|), as in chip_smoke.py
PLAN320 = "using Plan320 = Cfg<320, 8, 2, true>;"
STORE_Y = ("tma_store_3d_hint(&tm_y, s_x + (h * kBM + xrow) * kRowBytes, h * 64, row0 + xrow, 0,\n"
           "                          once);")
VARIANTS = {  # name: (old, new) string replacements in geglu_ff.cu
    "as built": [],
    "no L2 cache hints": [
        ("tma_load_3d_hint(s_x + h * kBM * kRowBytes, &tm_x, x_full, h * 64, row0, 0, once);",
         "tma_load_3d(s_x + h * kBM * kRowBytes, &tm_x, x_full, h * 64, row0, 0);"),
        ("ks * 64, src, 0, keep);", "ks * 64, src, 0);"),
        ("chunk * 64, r, 0, keep);", "chunk * 64, r, 0);"),
        ("tma_load_3d_hint(s_w1", "tma_load_3d(s_w1"),
        ("tma_load_3d_hint(s_w2", "tma_load_3d(s_w2"),
        (STORE_Y, "tma_store_3d(&tm_y, s_x + (h * kBM + xrow) * kRowBytes, h * 64, row0 + xrow, "
                  "0);")],
    "320: no ping-pong": [(PLAN320, "using Plan320 = Cfg<320, 8, 2, false>;")],
    "320: a wait for each slab": [("static constexpr bool kWaitEachSlab = !kPingPong;",
                                   "static constexpr bool kWaitEachSlab = true;")],
    "320: 10 W1 stages, 1 W2 stage": [(PLAN320, "using Plan320 = Cfg<320, 10, 1, true>;")],
    # Diagnostics, whose outputs are wrong: the time without one piece.
    "no weight copies (diagnostic)": [
        ("mbar_arrive_expect_tx(&full1[s], K::kW1Stage);", "mbar_arrive(&full1[s]);"),
        ("for (int b = 0; b < K::kW1Boxes; ++b)", "for (int b = 0; b < 0; ++b)"),
        ("mbar_arrive_expect_tx(&full2[s], K::kW2Stage);", "mbar_arrive(&full2[s]);"),
        ("for (int r = 0; r < C; r += K::kW2Box)", "for (int r = 0; r < 0; r += K::kW2Box)")],
    "no epilogue stores (diagnostic)": [(STORE_Y, "(void)once;")],
    "no gelu (diagnostic)": [
        ("const float gelu = round_bf16(0.5f * gb * (1.0f + erff(gb * 0.70710678118654752f)));",
         "const float gelu = gb;")],
}
DIAGNOSTIC = {name for name in VARIANTS if name.endswith("(diagnostic)")}
# (rows, width, LayerNorm in front): one row; ragged tiles; a tile's worth
CHECKS = [(1, 320, False), (1001, 320, False), (129, 320, True), (999, 640, False),
          (65, 640, True), (64, 640, False), (4096, 320, True), (64000, 320, False)]
TIMED = [(64000, 320), (16000, 640), (128000, 320), (32000, 640), (640000, 320), (160000, 640)]


def operands(m, c, ln=False, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    inner = 4 * c

    def draw(shape, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(shape, generator=gen, device="cuda")).bfloat16()

    ops = [draw((m, c)), draw((2 * inner, c), c**-0.5), draw((2 * inner,), 0.1),
           draw((c, inner), inner**-0.5), draw((c,), 0.1)]
    if ln:
        ops = [draw((m, c), 1.5, 0.3), draw((c,), 0.2, 1.0), draw((c,), 0.2)] + ops[1:]
    return ops


def ptxas_report(log: str) -> list[str]:
    """ptxas's lines about the K6 kernels: registers, spills, serialised wgmma."""
    lines, on = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            on = "geglu_ff_kernel" in line
            if on:
                cfg = line[line.index("CfgILi"):].split("EEE")[0]
                lines.append(f"entry {cfg}{' with LayerNorm' if 'ELb1EEEv' in line else ''}")
        elif on and ("Used" in line or "spill" in line or "C75" in line or "arning" in line):
            lines.append(line.strip())
    return lines


def main() -> None:
    if sys.argv[1:]:
        raise SystemExit(f"ab_geglu_ff: takes no arguments, got {sys.argv[1:]}")
    if not torch.cuda.is_available():
        raise SystemExit("ab_geglu_ff: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[ab] card {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    root = _build.BUILD_ROOT.parent / "ab"
    libs = {}
    for name, patches in VARIANTS.items():
        libs[name] = build(name, patches, root, "geglu_ff.cu")
        for line in ptxas_report(_build.build_info["log"]):
            print(f"[ab] {name}: ptxas {line}", flush=True)
    ok = True
    for name, lib in libs.items():
        _build._lib = lib
        for m, c, ln in CHECKS:
            ops = operands(m, c, ln, seed=m)
            fn, plain = ((geglu_ff.geglu_ff_ln, geglu_ff.geglu_ff_ln_plain) if ln
                         else (geglu_ff.geglu_ff, geglu_ff.geglu_ff_plain))
            out, again = fn(*ops), fn(*ops)
            ref = plain(*ops).float()
            diff = (out.float() - ref).abs()
            good = bool((diff <= TOL * (1 + ref.abs())).all()) and torch.equal(out, again)
            ok &= good or name in DIAGNOSTIC
            print(f"[ab] {name}: ({m}, {c}){' ln' if ln else ''}: max_abs_err "
                  f"{diff.max().item():.3e}, equal twice {torch.equal(out, again)}, ok {good}",
                  flush=True)
    order = list(libs) + list(libs)[::-1]
    for m, c in TIMED:
        ops = operands(m, c)
        times = {name: [] for name in libs}
        for name in order:
            _build._lib = libs[name]
            times[name].append(cuda_ms(lambda: geglu_ff.geglu_ff(*ops)))
        lib_ms = cuda_ms(lambda: geglu_ff.geglu_ff_unfused(*ops))
        print(f"[ab] ({m}, {c}) ms: " + "; ".join(f"{n} {a:.4f} {b:.4f}"
                                                  for n, (a, b) in times.items())
              + f"; library chain {lib_ms:.4f}", flush=True)
    if not ok:
        raise SystemExit("ab_geglu_ff: a variant disagrees with the plain version")


if __name__ == "__main__":
    sys.exit(main())
