"""The port's headline benchmark: 25-frame 512x320 Box2Video clips on one card.

Counterpart of the JAX package's ``bench.py``, with its protocol:
``StableVideoControlPipeline`` at the SVD-XT widths with seeded random bf16
weights (generation quality does not matter to the time; the work is the
same), CFG 1 -> 3, 25 Euler steps, ControlNet + UNet each step, the VAE
decode in chunks of 8, the "seq" temporal layout. One untimed warm-up
request, then ``--runs`` timed requests with seeds 1..N, each fenced by
``torch.cuda.synchronize`` and by a checksum of the clip that must be finite.

    python -m ctrlv_tpu_torch.tools.bench [--workload box2video|overall] [--runs 5]
        [--temporal_layout seq|frames_major] [--geglu_ff on|off] [--fused_resblock]
        [--tiny] [--device cpu]

Prints one JSON line in ``bench.py``'s form (``metric``, ``value``, ``unit``,
``vs_baseline``, ``detail``): ``value`` is the median of the timed runs in
s/clip, ``vs_baseline`` the 18 s/clip A100 estimate over it (BASELINE.md).
``detail`` holds the runs' times, their min and spread ((max - min) /
median), the models' set-up, the kernels' build or load and the warm-up
request apart, the peak device memory of a timed run, each kernel's launches
in one timed run, the FLOPs of a clip (``tools/flops.py``) and the MFU
against the bf16 peak, the temporal layout and the card's name and power
limit. ``--workload overall`` adds a second line: one ``OverallPipeline``
request at the JAX defaults (five stage-1 candidates in one batch through a
frames-major UNet, 30 + 25 steps), timed once after the Box2Video runs, with
its stage split.

``--tiny`` runs the same code on small configs (``flops.model_configs``; 3
frames of 16x16, 2 steps) in seconds, for the CPU tests; its metric names say its size and its
device numbers are null. Without ``--device`` the bench runs on the card and
raises where there is none.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import numpy as np
import torch

from ..models import (
    AutoencoderKLTemporalDecoder,
    CLIPVisionModelWithProjection,
    ControlNetSpatioTemporal,
    UNetSpatioTemporalConditionModel,
)
from ..models.transformer_st import TransformerSpatioTemporalModel
from ..ops import _build, _launch, geglu_ff, resblock
from ..pipelines import (
    GUIDANCE_PAIRS,
    OverallPipeline,
    StableVideoControlPipeline,
    VideoDiffusionPipeline,
)
from ..pipelines.common import resolve_device
from ..utils.profiling import StepTimer, annotate
from . import flops

A100_EST_SEC_PER_CLIP = 18.0  # bench.py's estimate for the same workload (BASELINE.md)
SIZE = dict(frames=25, height=320, width=512, steps=25, stage1_steps=30, chunk=8)
TINY_SIZE = dict(frames=3, height=16, width=16, steps=2, stage1_steps=2, chunk=2)
# Each model's seed; unet1 is the stage-1 UNet (frames-major), the others Box2Video's.
SEEDS = {"unet": 100, "ctrl": 101, "vae": 102, "clip": 103, "unet1": 104}


@torch.no_grad()
def init_random_(module: torch.nn.Module, seed: int) -> None:
    """Seeded random weights: matrices and kernels N(0, 1/fan_in), norm
    weights 1, biases 0, the CLIP class embedding N(0, 0.02); the blend
    factors keep their constructor values. The ControlNet's zero convs get
    random weights too, so that its residuals carry signal."""
    gen = torch.Generator(device=next(module.parameters()).device).manual_seed(seed)
    for name, p in module.named_parameters():
        if name.endswith("mix_factor"):
            continue
        if p.dim() >= 2:
            p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)
        elif name.endswith("class_embedding"):
            p.normal_(0.0, 0.02, generator=gen)
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.fill_(1.0)


def build_models(device, names=tuple(SEEDS), tiny: bool = False, **net_kw) -> dict:
    """The models of ``names`` (keys of ``SEEDS``) on ``device`` with seeded
    random weights in bf16, in eval mode and asking for no gradient: the
    Box2Video UNet and ControlNet, the VAE and CLIP that both stages share,
    the stage-1 UNet (frames-major). ``net_kw`` goes to the UNets and the
    ControlNet (``gradient_checkpointing``, ``remat_granularity``)."""
    ucfg, vcfg, ccfg = flops.model_configs(tiny)
    make = {
        "unet": lambda: UNetSpatioTemporalConditionModel(ucfg, **net_kw),
        "ctrl": lambda: ControlNetSpatioTemporal(ucfg, **net_kw),
        "vae": lambda: AutoencoderKLTemporalDecoder(vcfg),
        "clip": lambda: CLIPVisionModelWithProjection(ccfg),
        "unet1": lambda: UNetSpatioTemporalConditionModel(ucfg, temporal_layout="frames_major",
                                                          **net_kw),
    }
    models = {}
    with torch.device(device):
        for name in names:
            m = make[name]()
            init_random_(m, SEEDS[name])
            models[name] = m.to(torch.bfloat16).eval().requires_grad_(False)
    return models


def set_temporal_layout(nets, layout: str) -> None:
    """The temporal attention's layout ("seq": K2, "frames_major": K3) in
    every spatio-temporal transformer of ``nets``."""
    for net in nets:
        for m in net.modules():
            if isinstance(m, TransformerSpatioTemporalModel):
                m.temporal_layout = layout


def synthetic_request(seed: int, frames: int = 25, height: int = 320, width: int = 512):
    """A first frame (1, H, W, 3) and bbox frames (1, F, H, W, 3) in [-1, 1],
    drawn with numpy: three boxes moving across a dark frame, outlined in their
    own colours, over a smooth image."""
    rng = np.random.default_rng(seed)
    out = np.full((frames, height, width, 3), -1.0, np.float32)
    for _ in range(3):
        bw, bh = rng.uniform(width / 12, width / 4), rng.uniform(height / 10, height / 4)
        x0, y0 = rng.uniform(0, width - bw), rng.uniform(0, height - bh)
        dx, dy = rng.uniform(-width, width) / 150, rng.uniform(-height, height) / 150
        colour = rng.uniform(-0.5, 1.0, size=3).astype(np.float32)
        for f in range(frames):
            x1 = int(np.clip(x0 + dx * f, 0, width - bw - 1))
            y1 = int(np.clip(y0 + dy * f, 0, height - bh - 1))
            x2, y2 = x1 + int(bw), y1 + int(bh)
            out[f, y1:y2, x1:x1 + 2] = colour
            out[f, y1:y2, x2 - 2:x2] = colour
            out[f, y1:y1 + 2, x1:x2] = colour
            out[f, y2 - 2:y2, x1:x2] = colour
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, size=3)
    image = np.stack(
        [np.sin(xx / 37.0 + phase[c]) * np.cos(yy / 23.0 - phase[c]) for c in range(3)], -1
    ).astype(np.float32) * 0.8
    return torch.from_numpy(image[None]), torch.from_numpy(out[None])


def card_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them; "cpu" on the CPU."""
    if device.type != "cuda":
        return "cpu"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={device.index or 0}"], capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{torch.cuda.get_device_name(device)} (nvidia-smi: {type(e).__name__})"
    if smi.returncode != 0 or not smi.stdout.strip():
        return f"{torch.cuda.get_device_name(device)} (nvidia-smi exit {smi.returncode})"
    return smi.stdout.strip().splitlines()[0]


def setup(device_arg) -> tuple:
    """(device, card, build seconds, whether nvcc ran). On the card, TF32 is
    allowed as in ``chip_smoke.py`` (the bf16 models' only f32 matmuls take
    bf16 values upcast, which TF32 holds exactly), and the kernel library is
    built or loaded here, before anything is timed."""
    device = resolve_device(device_arg)
    if device.type != "cuda":
        return device, card_name(device), None, None
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    t0 = time.perf_counter()
    _build.load()
    return device, card_name(device), time.perf_counter() - t0, bool(_build.build_info["built"])


def add_switch_args(ap: argparse.ArgumentParser) -> None:
    """The port's own switches, each at its default unless given."""
    ap.add_argument("--temporal_layout", default="seq", choices=["seq", "frames_major"],
                    help="the Box2Video nets' temporal attention: seq (K2) or frames_major (K3)")
    ap.add_argument("--geglu_ff", default="on", choices=["on", "off"],
                    help="K6 on the feed-forwards that want no gradient (on by default)")
    ap.add_argument("--fused_resblock", action="store_true", help="K7 on (off by default)")


def apply_switches(args) -> None:
    geglu_ff.set_fused_geglu_ff(args.geglu_ff == "on")
    resblock.set_fused_resblock(args.fused_resblock)


def checksum(frames) -> float:
    """The clip's sum, read on the host: the fence of a timed request, and a
    guard that it was computed."""
    total = float(frames.float().sum())
    if not math.isfinite(total):
        raise RuntimeError(f"non-finite clip checksum {total}")
    return total


def peak_gib(device):
    return torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None


def reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def mfu(tflop: float, secs: float, device):
    """The share of the card's bf16 peak; None off the card."""
    return tflop * 1e12 / secs / flops.PEAK_BF16 if device.type == "cuda" else None


def bench_box2video(models, device, size: dict, runs: int, tflop: float, common: dict) -> dict:
    pipe = StableVideoControlPipeline(models["unet"], models["ctrl"], models["vae"],
                                      models["clip"], device=device)
    timer = StepTimer(warmup=1, device=device)
    peaks = []
    for seed in range(runs + 1):  # seed 0 is the warm-up
        image, cond = synthetic_request(seed, size["frames"], size["height"], size["width"])
        gen = torch.Generator(device=device).manual_seed(seed)
        reset_peak(device)
        _launch.reset_launch_counts()
        with annotate(f"box2video request {seed}"), timer:
            checksum(pipe(image, cond, generator=gen, num_frames=size["frames"],
                          num_inference_steps=size["steps"], min_guidance_scale=1.0,
                          max_guidance_scale=3.0, decode_chunk_size=size["chunk"]))
        if seed == 0:
            warmup_s = timer.last_s
        else:
            peaks.append(peak_gib(device))
    times = timer.times
    med = float(np.median(times))
    full = size == SIZE
    return {
        "metric": f"box2video_{size['frames']}f_{size['width']}x{size['height']}_sec_per_clip",
        "value": med,
        "unit": "s/clip",
        "vs_baseline": A100_EST_SEC_PER_CLIP / med if full else None,
        "detail": dict(
            common, steps=size["steps"], runs=runs, times_s=times, min_s=min(times),
            spread=(max(times) - min(times)) / med, warmup_s=warmup_s,
            peak_gib=max(peaks) if device.type == "cuda" else None,
            launches=dict(_launch.LAUNCHES), tflop_per_clip=tflop, mfu=mfu(tflop, med, device),
        ),
    }


def bench_overall(models, device, size: dict, tflop: float, common: dict) -> dict:
    """One two-stage request, timed once, with the seconds of each stage
    read through the pipelines' own calls; the select is the rest."""
    bbox = VideoDiffusionPipeline(models["unet1"], models["vae"], models["clip"], device=device)
    ctrl = StableVideoControlPipeline(models["unet"], models["ctrl"], models["vae"],
                                      models["clip"], device=device)
    pipe = OverallPipeline(bbox, ctrl)
    stage_s = {}

    def timed(name, fn):
        def call(*args, **kwargs):
            with annotate(name), StepTimer(warmup=0, device=device) as t:
                out = fn(*args, **kwargs)
            stage_s[name] = t.last_s
            return out
        return call

    pipe.bbox_pipeline, pipe.ctrl_pipeline = timed("stage1", bbox), timed("stage2", ctrl)
    image, cond = synthetic_request(2, size["frames"], size["height"], size["width"])
    gen = torch.Generator(device=device).manual_seed(2)
    timer = StepTimer(warmup=0, device=device)
    reset_peak(device)
    _launch.reset_launch_counts()
    with annotate("overall request"), timer:
        res = pipe(image[0], cond[0], generator=gen, num_frames=size["frames"],
                   stage1_steps=size["stage1_steps"], stage2_steps=size["steps"],
                   decode_chunk_size=size["chunk"])
        checksum(torch.as_tensor(res["video"]))
    secs = timer.last_s
    return {
        "metric": f"overall_request_{size['frames']}f_{size['width']}x{size['height']}"
                  "_sec_per_request",
        "value": secs,
        "unit": "s/request",
        "vs_baseline": None,
        "detail": dict(
            common, candidates=len(GUIDANCE_PAIRS), stage1_steps=size["stage1_steps"],
            stage2_steps=size["steps"], runs=1, times_s=[secs], stage1_s=stage_s["stage1"],
            stage2_s=stage_s["stage2"], select_s=secs - stage_s["stage1"] - stage_s["stage2"], peak_gib=peak_gib(device),
            launches=dict(_launch.LAUNCHES), tflop_per_request=tflop,
            mfu=mfu(tflop, secs, device), best_guidance=list(res["best_guidance"]),
            miou=res["miou"],
        ),
    }


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="box2video", choices=["box2video", "overall"],
                    help="overall: the Box2Video line, then one overall request")
    ap.add_argument("--runs", type=int, default=5, help="timed Box2Video requests")
    add_switch_args(ap)
    ap.add_argument("--tiny", action="store_true",
                    help="small configs (flops.model_configs), for the CPU tests")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    if args.runs < 1:
        ap.error("--runs must be at least 1")

    device, card, build_s, built = setup(args.device)
    apply_switches(args)
    size = TINY_SIZE if args.tiny else SIZE
    overall = args.workload == "overall"
    names = tuple(SEEDS) if overall else ("unet", "ctrl", "vae", "clip")
    t0 = time.perf_counter()
    models = build_models(device, names, tiny=args.tiny)
    set_temporal_layout((models["unet"], models["ctrl"]), args.temporal_layout)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    init_s = time.perf_counter() - t0

    # FLOPs by component on meta (on the CPU for the small configs)
    count = flops.counting_models(tiny=args.tiny, stage1=overall,
                                  device="cpu" if args.tiny else flops.META)
    fsize = dict(frames=size["frames"], height=size["height"], width=size["width"],
                 chunk=size["chunk"])
    clip_tflop = flops.box2video_flops(count, steps=size["steps"], **fsize)["total"] / 1e12
    common = dict(init_s=init_s, build_s=build_s, built=built,
                  temporal_layout=args.temporal_layout, geglu_ff=args.geglu_ff,
                  fused_resblock=args.fused_resblock, config="tiny" if args.tiny else "svd-xt",
                  device=card)
    lines = [bench_box2video(models, device, size, args.runs, clip_tflop, common)]
    print(json.dumps(lines[-1]), flush=True)
    if overall:
        request_tflop = flops.overall_flops(count, stage1_steps=size["stage1_steps"],
                                            stage2_steps=size["steps"], **fsize)["total"] / 1e12
        lines.append(bench_overall(models, device, size, request_tflop, common))
        print(json.dumps(lines[-1]), flush=True)
    return lines


if __name__ == "__main__":
    main()
