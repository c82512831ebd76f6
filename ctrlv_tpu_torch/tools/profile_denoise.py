"""Device time of the full-width ControlNet+UNet denoise step, by kernel and by kind.

Counterpart of the JAX package's ``tools/profile_denoise.py`` (without its
xplane parser): ``torch.profiler`` over ``--steps`` denoise steps at the
Box2Video shape (CFG batch 2 x 25 frames of 40x64 latents, bf16, seeded
random weights), the device time of each kernel summed by name (the by-op
table: name, calls, ms a step, share) and by kind (``KERNEL_KINDS``).

    python -m ctrlv_tpu_torch.tools.profile_denoise [--steps 3] [--top 40] [--raw N]
        [--out FILE.json] [--trace_dir DIR] [--attention_impl auto|xla|pallas]
        [--fused_resblock] [--temporal_layout seq|frames_major] [--geglu_ff on|off]
        [--tiny] [--device cpu]

Prints the wall time of a step (CUDA-synchronised, the mean of 5 after two
warm-up steps), the device time a step, the table by kind and the first
``--top`` rows by op (``--raw N``: N rows with their full names), then one
JSON line with the same numbers. ``--out`` writes every row as JSON,
``--trace_dir`` a Chrome trace. On the CPU (``--tiny --device cpu``, for the
tests) the rows are the host's self time of each op, and the JSON says so
(``"clock": "cpu"``): no device time exists there.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..ops.attention import set_attention_impl
from ..utils.profiling import StepTimer
from . import bench, flops

# Kinds of device kernel by a word of the name torch.profiler reports; the
# first kind with a match wins.
KERNEL_KINDS = (
    ("K2 + K3 (small_mha.cu)", ("small_mha_fwd_kernel",)),
    ("K1 + K8 (mha.cu)", ("mha_fwd_kernel",)),
    ("K7 (resblock.cu)", ("namespace)::conv_kernel", "namespace)::gn_sums_kernel",
                          "namespace)::relayout_kernel")),
    ("K4 (group_norm.cu)", ("namespace)::gn_",)),
    ("K5 (layer_norm.cu)", ("namespace)::ln_",)),
    ("K6 (geglu_ff.cu, geglu_ff_wide.cu)", ("geglu_ff_kernel", "geglu_ff_wide_kernel")),
    ("cuDNN NCHW<->NHWC transforms", ("nchwToNhwc", "nhwcToNchw")),
    ("convolutions (cuDNN)", ("cudnn", "implicit_gemm", "conv")),
    ("matmuls (cuBLAS)", ("nvjet", "gemm", "cutlass")),
    ("copies and casts", ("copy", "Memcpy", "CatArray")),
    ("softmax and reductions", ("softmax", "reduce")),
    ("elementwise (adds, muls, gelu, SiLU)", ("elementwise",)),
)


def kind_of(name: str) -> str:
    return next((k for k, words in KERNEL_KINDS if any(w in name for w in words)), "other")


def make_step(ctrl, unet, device, frames: int, h: int, w: int):
    """A ControlNet+UNet denoise step on seeded inputs (CFG batch 2 x
    ``frames`` latents of h x w), as a closure returning the f32 prediction."""
    gen = torch.Generator(device=device).manual_seed(3)
    cfg = unet.config
    lat = torch.randn((2, frames, h, w, cfg.in_channels), generator=gen, device=device)
    cond = torch.randn((2, frames, h, w, cfg.in_channels // 2), generator=gen, device=device)
    emb = torch.randn((2, 1, cfg.cross_attention_dim), generator=gen, device=device)
    tids = torch.tensor([[6.0, 127.0, 0.02]] * 2, device=device)
    t = torch.tensor(0.25 * np.log(10.0), device=device)

    @torch.no_grad()
    def step():
        down, mid = ctrl(lat, t, emb, tids, cond)
        return unet(lat, t, emb, tids, down_block_additional_residuals=down,
                    mid_block_additional_residuals=mid).float()

    return step


def aggregate(prof, n_steps: int) -> dict:
    """Time by name over a profile of ``n_steps`` steps, per step: the
    device's kernels where the profile holds any (``"clock": "cuda"``), else
    the host's self time of each op (``"clock": "cpu"``). ``by_op`` rows are
    {name, calls, ms, share}, by time, and sum to ``total_ms``; ``by_kind``
    sums them by ``KERNEL_KINDS``."""
    events = list(prof.key_averages())
    cuda = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    if cuda:
        clock, rows = "cuda", [(e.key, e.count, e.self_device_time_total) for e in cuda]
    else:
        clock, rows = "cpu", [(e.key, e.count, e.self_cpu_time_total) for e in events
                              if e.device_type == torch.autograd.DeviceType.CPU]
    rows = [(name, calls, us / 1e3 / n_steps) for name, calls, us in rows if us > 0]
    total = sum(ms for _, _, ms in rows)
    by_op = [{"name": name, "calls": calls / n_steps, "ms": ms, "share": ms / total}
             for name, calls, ms in sorted(rows, key=lambda r: -r[2])]
    by_kind = {}
    for row in by_op:
        kind = kind_of(row["name"])
        by_kind[kind] = by_kind.get(kind, 0.0) + row["ms"]
    return {"clock": clock, "total_ms": total, "calls": sum(r["calls"] for r in by_op),
            "by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])), "by_op": by_op}


def profile_steps(step, n_steps: int, device, trace_dir=None) -> dict:
    """``aggregate`` of ``n_steps`` calls of ``step`` under torch.profiler,
    the card synchronised inside the window; the Chrome trace goes to
    ``trace_dir`` where given."""
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if device.type == "cuda" else [])
    handler = torch.profiler.tensorboard_trace_handler(trace_dir) if trace_dir else None
    with profile(activities=activities, on_trace_ready=handler) as prof:
        for _ in range(n_steps):
            step()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return aggregate(prof, n_steps), prof


def print_table(table: dict, top: int, tag: str = "", width: int = 90) -> None:
    unit = "device" if table["clock"] == "cuda" else "host (cpu)"
    for kind, ms in table["by_kind"].items():
        print(f"{tag}  {kind}: {ms:.3f} ms, {100 * ms / table['total_ms']:.1f} %")
    print(f"{tag}by op, {unit} ms a step (calls a step, share):")
    for row in table["by_op"][:top]:
        name = row["name"] if width is None else row["name"][:width]
        print(f"{tag}  {row['ms']:9.3f} ms {row['calls']:7.1f} {100 * row['share']:5.1f} %  "
              f"{name}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3, help="steps under the profiler")
    ap.add_argument("--out", default=None, help="write the tables as JSON here")
    ap.add_argument("--trace_dir", default=None, help="write a Chrome trace here")
    ap.add_argument("--top", type=int, default=40, help="rows of the by-op table printed")
    ap.add_argument("--raw", type=int, default=0, help="also print N rows with full names")
    ap.add_argument("--attention_impl", default="auto", choices=["auto", "xla", "pallas"])
    bench.add_switch_args(ap)
    ap.add_argument("--tiny", action="store_true",
                    help="small configs (flops.model_configs), for the CPU tests")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be at least 1")

    device, card, _, _ = bench.setup(args.device)
    set_attention_impl(args.attention_impl)
    bench.apply_switches(args)
    models = bench.build_models(device, ("unet", "ctrl"), tiny=args.tiny)
    bench.set_temporal_layout(models.values(), args.temporal_layout)
    size = bench.TINY_SIZE if args.tiny else bench.SIZE
    scale = flops.model_configs(args.tiny)[1].spatial_scale
    step = make_step(models["ctrl"], models["unet"], device, size["frames"],
                     size["height"] // scale, size["width"] // scale)

    timer = StepTimer(warmup=2, device=device)
    for _ in range(7):
        with timer:
            out = step()
    if not math.isfinite(float(out.sum())):
        raise RuntimeError("the denoise step gave non-finite values")
    wall_ms = 1e3 * timer.summary()["mean_s"]
    table, _ = profile_steps(step, args.steps, device, args.trace_dir)
    unit = "device" if table["clock"] == "cuda" else "host (cpu)"
    print(f"wall per step: {wall_ms:.3f} ms; {unit} total per step: {table['total_ms']:.3f} ms, "
          f"{table['calls']:.0f} calls; layout {args.temporal_layout}; card {card}")
    print_table(table, args.top)
    if args.raw:
        print(f"---- top {args.raw} by op, full names ----")
        print_table(dict(table, by_kind={}), args.raw, width=None)
    summary = dict(steps=args.steps, wall_ms_per_step=wall_ms, clock=table["clock"],
                   ms_per_step=table["total_ms"], calls_per_step=table["calls"],
                   by_kind=table["by_kind"], top=table["by_op"][:args.top],
                   temporal_layout=args.temporal_layout, geglu_ff=args.geglu_ff,
                   fused_resblock=args.fused_resblock, attention_impl=args.attention_impl,
                   device=card)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(dict(summary, by_op=table["by_op"]), fh, indent=1)
    print(json.dumps(summary), flush=True)
    return dict(summary, by_op=table["by_op"])


if __name__ == "__main__":
    main()
