"""A/B of K4 (``csrc/group_norm.cu``) and K5 (``csrc/layer_norm.cu``) on one
card: the parent design against this tree's, with the variants of its plans.

    python3 -m ctrlv_tpu_torch.tools.ab_norms

"parent" is the design these kernels replaced: its two sources are kept in
``ab_norms_parent/`` and built apart under ``build/ab/parent/``, and they are
called through a copy of its wrappers and of its launch path (a
``torch.cuda.device`` context and a stream lookup a call). The new kernels
come from the package, through its own launch path, once with each plan of
``NEW_K5`` and ``_k4_variants`` (the plans' knobs are run-time numbers), and
from the copies of the sources that ``PATCHED`` builds apart under
``build/ab/<name>/`` (``ab_mha.build``).

Every variant is held against the plain version at ragged shapes (and two
runs against each other, to the bit), and K4's variants also at the SiLU
probe of ``chip_smoke.py`` (within one bf16 ulp at normalised values in
[-10, 0]). Then each timed K4 and K5 shape of
``chip_smoke.py``'s ``KERNEL_CASES`` runs through all variants in turns
(forward, then backward), each read as device time (``timing.device_ms``:
the calls queued behind a sleep of the card, median of 7 windows of 8
calls), beside the library call (``F.group_norm`` + ``F.silu``,
``F.layer_norm``); the host's µs to enqueue one call are printed for the
parent's and the new launch paths. Prints the card's name and power limit
first. Needs the card and nvcc; exits non-zero if a build fails or a variant
disagrees with the plain version.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from ctrlv_tpu_torch.ops import _build, _launch, group_norm, layer_norm
from ctrlv_tpu_torch.tools.ab_mha import build
from ctrlv_tpu_torch.tools.timing import device_ms

TOL = 1e-2  # |kernel - plain| <= TOL * (1 + |plain|), as in chip_smoke.py
PARENT_CSRC = Path(__file__).resolve().parent / "ab_norms_parent"
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


class Parent:
    """The parent's K4 and K5: its sources, its wrappers, its launch path."""

    SMEM_RUN_ELEMS, SPLIT_ELEMS, MAX_SPLITS = 80 * 1024, 16 * 1024, 64

    def __init__(self, root: Path):
        out = root / "parent"
        out.mkdir(parents=True, exist_ok=True)
        nvcc = _build.cuda_tool()
        srcs = sorted(PARENT_CSRC.glob("*.cu"))
        objs = [out / f"{p.stem}.o" for p in srcs]
        procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(o), str(p)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for p, o in zip(srcs, objs)]
        for proc in procs:
            log, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"ab_norms: the parent's sources failed to build:\n{log}")
        lib_path = out / "libparent_norms.so"
        subprocess.run([nvcc, "-shared", "-o", str(lib_path), *map(str, objs)], check=True)
        self.lib = ctypes.CDLL(str(lib_path))
        self.lib.ctrlv_group_norm_fwd.argtypes = [_P] * 5 + [_L] * 3 + [_I] * 5 + [_F, _P]
        self.lib.ctrlv_layer_norm_fwd.argtypes = [_P] * 4 + [_I] * 3 + [_F, _P]
        for fn in (self.lib.ctrlv_group_norm_fwd, self.lib.ctrlv_layer_norm_fwd):
            fn.restype = ctypes.c_int

    @staticmethod
    def launch(fn, device, *args):
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"ab_norms: the parent's kernel failed with cudaError {rc}")

    def group_norm(self, x, weight, bias, groups, eps, act):
        for t in (x, weight, bias):
            _launch.check_operand("group_norm", t, t.dtype, x.device)
        runs, spatial = x.shape[0] * groups, x[0, 0].numel()
        run = (x.shape[1] // groups) * spatial
        out = torch.empty_like(x)
        if run <= self.SMEM_RUN_ELEMS:
            splits, scratch_ptr = 1, 0
        else:
            splits = min(self.MAX_SPLITS, max(2, -(-run // self.SPLIT_ELEMS)))
            scratch = torch.empty((runs, splits, 2), dtype=torch.float32, device=x.device)
            scratch_ptr = scratch.data_ptr()
        self.launch(self.lib.ctrlv_group_norm_fwd, x.device, x.data_ptr(), weight.data_ptr(),
                    bias.data_ptr(), out.data_ptr(), scratch_ptr, ctypes.c_longlong(runs),
                    ctypes.c_longlong(run), ctypes.c_longlong(spatial), x.shape[1] // groups,
                    groups, splits, int(weight.dtype == torch.bfloat16), int(act == "silu"),
                    ctypes.c_float(eps))
        return out

    def layer_norm(self, x, weight, bias, eps):
        for t in (x, weight, bias):
            _launch.check_operand("layer_norm", t, t.dtype, x.device)
        c = x.shape[-1]
        out = torch.empty_like(x)
        self.launch(self.lib.ctrlv_layer_norm_fwd, x.device, x.data_ptr(), weight.data_ptr(),
                    bias.data_ptr(), out.data_ptr(), x.numel() // c, c,
                    int(weight.dtype == torch.bfloat16), ctypes.c_float(eps))
        return out


# K5 variants: blocks an SM of the persistent grid
NEW_K5 = {"2/SM": 2, "3/SM": 3, "4/SM": 4}
# Variants of the sources, patched by exact string replacements and built apart
# (ab_mha.build): name -> (source, [(old, new)]); run at K4's default plans
PATCHED = {
    "SiLU by exact division": ("group_norm.cu", [(
        "__fdividef(y, 1.f + __expf(-y))", "y / (1.f + __expf(-y))")]),
}


def _k4_variants(shape, groups):
    """Name -> plan of the new K4 at ``shape``: the default plan, the short
    path's CTAs an SM and item sizes, clusters of 2 to 16 CTAs, and the
    two-pass path, where each can take the shape."""
    dims = group_norm._dims(shape, groups)
    out = {"default": group_norm._plan(tuple(shape), groups)}
    for ctas in (2, 3, 4):
        for item in (8 * 1024, 16 * 1024, 32 * 1024):
            out[f"short {ctas}/SM, items <= {item // 1024} KB"] = group_norm.short_plan(
                *dims, ctas=ctas, item_bytes=item, min_stages=1)
    for cs in (2, 4, 8, 16):
        out[f"cluster of {cs}"] = group_norm.cluster_plan(*dims, cs=cs)
    out["two-pass"] = group_norm.two_pass_plan(*dims)
    return {name: plan for name, plan in out.items() if plan is not None}


def _operands(kind, shape, seed, groups=32):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[1] if kind == "group_norm" else shape[-1]
    x = (1.5 * torch.randn(shape, generator=gen, device="cuda") + 0.3).bfloat16()
    w = (1.0 + 0.2 * torch.randn(c, generator=gen, device="cuda")).bfloat16()
    b = (0.2 * torch.randn(c, generator=gen, device="cuda")).bfloat16()
    return x, w, b


def _on(lib, fn):
    """``fn`` called with ``lib`` as the kernel library in use."""
    def call():
        _build._lib = lib
        return fn()
    return call


def _fns(kind, spec, parent, libs, x, w, b):
    """Name -> closure: the parent, each new variant (``libs``: the package's
    library, then the patched ones by name), and the library call."""
    package = libs["package"]
    if kind == "layer_norm":
        rows, c = x.numel() // x.shape[-1], x.shape[-1]
        fns = {"parent": lambda: parent.layer_norm(x, w, b, 1e-5)}
        for name, ctas in NEW_K5.items():
            plan = layer_norm._plan(rows, c, ctas)
            fns[name] = _on(package, lambda plan=plan: layer_norm._layer_norm_cuda(
                x, w, b, 1e-5, plan))
        fns["library"] = lambda: F.layer_norm(x, (c,), w, b, 1e-5)
        return fns
    groups, act = spec.get("groups", 32), spec.get("act")
    fns = {"parent": lambda: parent.group_norm(x, w, b, groups, 1e-5, act)}
    for name, plan in _k4_variants(x.shape, groups).items():
        fns[name] = _on(package, lambda plan=plan: group_norm._group_norm_cuda(
            x, w, b, groups, 1e-5, act, plan))
    for name, lib in libs.items():
        if name != "package" and act == "silu":
            fns[f"default, {name}"] = _on(lib, lambda: group_norm._group_norm_cuda(
                x, w, b, groups, 1e-5, act))

    def lib():
        y = F.group_norm(x, groups, w, b, 1e-5)
        return F.silu(y) if act == "silu" else y

    fns["library"] = lib
    return fns


def _plain(kind, spec, x, w, b):
    if kind == "layer_norm":
        return layer_norm.layer_norm_plain(x, w, b, 1e-5)
    return group_norm.group_norm_plain(x, w, b, spec.get("groups", 32), 1e-5, spec.get("act"))


# Ragged shapes and one of each path, for the check: (kind, spec)
CHECKS = [
    ("layer_norm", dict(shape=(257, 1280))), ("layer_norm", dict(shape=(3, 1001, 8))),
    ("layer_norm", dict(shape=(1001, 320))), ("layer_norm", dict(shape=(999, 640))),
    ("layer_norm", dict(shape=(33, 2048))), ("layer_norm", dict(shape=(65, 1288))),
    ("layer_norm", dict(shape=(5, 72))),
    ("group_norm", dict(shape=(3, 320, 40, 64), act="silu")),
    ("group_norm", dict(shape=(3, 2560, 5, 8), act="silu")),
    ("group_norm", dict(shape=(5, 2560, 5, 8), act=None)),
    ("group_norm", dict(shape=(1, 320, 25, 40, 64), act="silu")),
    ("group_norm", dict(shape=(1, 128, 320, 512), act="silu")),
    ("group_norm", dict(shape=(2, 33, 7, 9), act="silu", groups=3)),
    ("group_norm", dict(shape=(2, 6, 251, 163), act=None, groups=2)),
    ("group_norm", dict(shape=(2, 64, 24, 8), act="silu", groups=2)),
]


def main() -> None:
    if sys.argv[1:]:
        raise SystemExit(f"ab_norms: takes no arguments, got {sys.argv[1:]}")
    if not torch.cuda.is_available():
        raise SystemExit("ab_norms: needs a CUDA device")
    # the timed shapes and the SiLU probe; the script sits at the repo root
    from chip_smoke import KERNEL_CASES, SILU_PROBE, SILU_ULPS, bf16_ulps

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[ab] card {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    root = _build.BUILD_ROOT.parent / "ab"
    parent = Parent(root)
    libs = {"package": _build.load()}
    print(f"[ab] built the parent and the package ({_build.build_info['seconds']:.1f} s)",
          flush=True)
    for name, (source, patches) in PATCHED.items():
        libs[name] = build(name, patches, root, source)
    ok = True
    for seed, (kind, spec) in enumerate(CHECKS):
        x, w, b = _operands(kind, spec["shape"], seed)
        ref = _plain(kind, spec, x, w, b).float()
        for name, fn in _fns(kind, spec, parent, libs, x, w, b).items():
            if name == "library":
                continue
            out, again = fn(), fn()
            diff = (out.float() - ref).abs()
            good = bool((diff <= TOL * (1 + ref.abs())).all()) and torch.equal(out, again)
            ok &= good
            print(f"[ab] check {kind} {spec} {name}: max_abs_err {diff.max().item():.3e}, "
                  f"equal twice {torch.equal(out, again)}, ok {good}", flush=True)
        del x, w, b, ref
    # K4's SiLU at normalised values y = beta in [-10, 0] (gamma 0), as chip_smoke.py holds it
    spec = dict(shape=SILU_PROBE, act="silu")
    x = torch.randn(SILU_PROBE, generator=torch.Generator(device="cuda").manual_seed(0),
                    device="cuda").bfloat16()
    w = torch.zeros(SILU_PROBE[1], device="cuda")
    b = torch.linspace(-10.0, 0.0, SILU_PROBE[1], device="cuda")
    ref = _plain("group_norm", spec, x, w, b)
    for name, fn in _fns("group_norm", spec, parent, libs, x, w, b).items():
        if name == "library":  # F.group_norm takes no f32 parameters with bf16 x
            continue
        ulps = bf16_ulps(fn(), ref)
        ok &= ulps <= SILU_ULPS
        print(f"[ab] check SiLU at y in [-10, 0] {name}: {ulps} bf16 ulps from the plain version "
              f"(limit {SILU_ULPS})", flush=True)
    for kind, spec, timed in KERNEL_CASES:
        if not timed or kind not in ("group_norm", "layer_norm"):
            continue
        x, w, b = _operands(kind, spec["shape"], 0)
        fns = _fns(kind, spec, parent, libs, x, w, b)
        names = list(fns)
        dev, host = {n: [] for n in names}, {n: [] for n in names}
        for name in names + names[::-1]:
            d, h = device_ms(fns[name])
            dev[name].append(d)
            host[name].append(h)
        bound = 1e3 * 2 * (2 * x.numel() + 2 * w.numel()) / 3.35e12
        print(f"[ab] {kind} {spec} device ms (bound {bound:.4f}): " + "; ".join(
            f"{n} {a:.4f} {b_:.4f}" for n, (a, b_) in dev.items()), flush=True)
        print(f"[ab] {kind} {spec} host us a call: parent {min(host['parent']):.1f}, new "
              f"{min(host[names[1]]):.1f}, library {min(host['library']):.1f}", flush=True)
        if kind == "group_norm":
            print(f"[ab] {kind} {spec} plans: " + "; ".join(
                f"{n} {p}" for n, p in _k4_variants(x.shape, spec.get("groups", 32)).items()),
                flush=True)
        del x, w, b, fns
        torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("ab_norms: a variant disagrees with the plain version")


if __name__ == "__main__":
    sys.exit(main())
