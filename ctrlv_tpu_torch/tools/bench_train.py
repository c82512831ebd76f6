"""Training throughput at the SVD-XT widths on one card, one JSON line a regime.

Counterpart of the JAX package's ``tools/bench_train.py``, with its regimes
and batch: one clip of 25 frames at 512x320 a micro-step, the VAE encode in
chunks of 5 frames, block checkpointing, lr 1e-5, accumulation over
``--accum`` micro-steps, seeded random bf16 weights:

  controlnet    the ControlNet trained, UNet, VAE and CLIP frozen; AdamW, bf16 first moment
  controlnet-af the same with Adafactor
  temporal      the UNet's temporal transformer blocks alone (a partitioned subset); AdamW,
                bf16 first moment
  lora          rank-4 LoRA adapters on to_q/k/v/out.0 of the UNet; AdamW, f32 moments
  full          every UNet parameter; AdamW, bf16 first moment
  full-af       every UNet parameter; Adafactor

    python -m ctrlv_tpu_torch.tools.bench_train [--regime all|<name>[,<name>...]]
        [--accum 5] [--measure_steps 3] [--enc_chunk 5] [--remat block|sub]
        [--attention_impl auto|xla|pallas] [--out FILE] [--profile DIR]
        [--tiny] [--device cpu]

Each regime runs one optimizer update (``--accum`` micro-steps) untimed, then
``--measure_steps`` updates with every micro-step fenced and timed. A line
holds ``sec_per_micro_step`` (the median of the micro-steps that carry no
update, with their min and spread), ``sec_per_opt_step`` (the median time of
a whole update's micro-steps, the optimizer's Python loop included), the
FLOPs of a micro-step (``tools/flops.py``: forward, backward and the
checkpoint's recompute) and the MFU against the bf16 peak, the trainable
parameter count, the first micro-step's loss, the set-up seconds, the peak
device memory, whether f32 master weights were on (never: the parameters
are bf16, as in the JAX bench; the trainers keep f32 masters), each kernel's
launches in the last micro-step and the card's name and power limit. The models are
built once; each regime's optimizer state is freed before the next one
starts. A regime that fails prints ``{"regime", "error"}`` and the run goes on
to the next; the process then exits non-zero. ``--profile DIR`` (one regime)
traces one more update into DIR and adds its device time by kind to the line.
``--tiny --device cpu`` runs the same code on small configs
(``flops.model_configs``; 3 frames of 16x16) for the CPU tests. Not ported:
``--analyze`` (XLA's memory analysis; ``peak_gib`` stands in) and the
``*-split`` regimes.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
import traceback

import numpy as np
import torch

from ..ops import _launch
from ..ops.attention import get_attention_impl, set_attention_impl
from ..train import (
    MultiSteps,
    init_train_state,
    lora_init,
    make_controlnet_train_step,
    make_optimizer,
    make_svd_train_step,
    split_trainable,
    temporal_blocks_predicate,
)
from ..utils.profiling import StepTimer, annotate, trace
from . import bench, flops, profile_denoise

SIZE = dict(frames=25, height=320, width=512)
TINY_SIZE = dict(frames=3, height=16, width=16)
# regime: (what trains, the optimizer's keywords)
REGIMES = {
    "controlnet": ("controlnet", dict(mu_dtype="bfloat16")),
    "controlnet-af": ("controlnet", dict(optimizer="adafactor")),
    "temporal": ("temporal", dict(mu_dtype="bfloat16")),
    "lora": ("lora", {}),
    "full": ("full", dict(mu_dtype="bfloat16")),
    "full-af": ("full", dict(optimizer="adafactor")),
}


def trainable(models: dict, kind: str, device):
    """The tensors a regime trains, each asking for a gradient."""
    if kind == "controlnet":
        return models["ctrl"].train().requires_grad_(True)
    unet = models["unet"].train()
    if kind == "temporal":
        return split_trainable(unet, temporal_blocks_predicate)
    if kind == "lora":
        return lora_init(torch.Generator(device=device).manual_seed(42), unet, rank=4)
    return unet.requires_grad_(True)


def bench_regime(models: dict, regime: str, args, size: dict, device, tflop: float) -> dict:
    kind, opt_kw = REGIMES[regime]
    t0 = time.perf_counter()
    tx = make_optimizer(learning_rate=1e-5, nan_guard_steps=0, **opt_kw)
    if args.accum > 1:
        tx = MultiSteps(tx, args.accum)
    step_kw = dict(conditioning_dropout_prob=0.1, encode_chunk=args.enc_chunk, device=device)
    if kind == "controlnet":
        step = make_controlnet_train_step(models["unet"], models["ctrl"], models["vae"],
                                          models["clip"], tx, **step_kw)
    else:
        step = make_svd_train_step(models["unet"], models["vae"], models["clip"], tx,
                                   partitioned=kind == "temporal", lora=kind == "lora",
                                   **step_kw)
    state = init_train_state(trainable(models, kind, device), tx)
    n_train = sum(p.numel() for p in state.params.values())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    init_s = time.perf_counter() - t0

    gen = torch.Generator(device=device).manual_seed(7)
    shape = (1, size["frames"], size["height"], size["width"], 3)

    def micro_step(timer, i):
        clips, bbox = (2 * torch.rand(shape, generator=gen, device=device) - 1 for _ in range(2))
        _launch.reset_launch_counts()
        with annotate(f"{regime} micro-step {i}"), timer:
            _, metrics = step(state, clips, bbox, generator=gen)
        loss = float(metrics["loss"])
        if not math.isfinite(loss):
            raise RuntimeError(f"micro-step {i}: loss {loss}")
        return loss

    bench.reset_peak(device)
    accum = args.accum
    warm, timer = StepTimer(warmup=0, device=device), StepTimer(warmup=0, device=device)
    loss0 = [micro_step(warm, i) for i in range(accum)][0]  # the first update: the warm-up
    for i in range(args.measure_steps * accum):
        micro_step(timer, accum + i)
    times = timer.times
    updates = [(j + 1) % accum == 0 for j in range(len(times))]
    micro = [t for t, u in zip(times, updates) if not u] or times  # accum 1: each one updates
    opt = [sum(times[g * accum:(g + 1) * accum]) for g in range(args.measure_steps)]
    med = float(np.median(micro))
    line = {
        "regime": regime, "attention_impl": get_attention_impl(), "accum": accum,
        "device": args.card,
        "sec_per_micro_step": med, "sec_per_micro_step_min": min(micro),
        "sec_per_micro_step_spread": (max(micro) - min(micro)) / med,
        "sec_per_opt_step": float(np.median(opt)),
        "update_micro_step_s": float(np.median([t for t, u in zip(times, updates) if u])),
        "micro_steps_s": times,
        "mfu": bench.mfu(tflop, med, device),
        "tflop_per_micro_step": tflop,
        "trainable_params_m": n_train / 1e6,
        "loss_first_step": loss0,
        "init_s": init_s,
        "warmup_s": sum(warm.times),
        "peak_gib": bench.peak_gib(device),
        "f32_masters": False,
        "optimizer": opt_kw.get("optimizer", "adamw"), "mu_dtype": opt_kw.get("mu_dtype"),
        "remat": args.remat, "enc_chunk": args.enc_chunk,
        "launches": dict(_launch.LAUNCHES),
    }
    if args.profile:
        with trace(args.profile) as prof:
            for i in range(accum):
                micro_step(StepTimer(warmup=0, device=device), i)
        table = profile_denoise.aggregate(prof, accum)
        line["profile"] = {"ms_per_micro_step": table["total_ms"], "clock": table["clock"],
                           "by_kind": table["by_kind"], "trace_dir": args.profile}
    return line


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--regime", default="all",
                    help=f"all, or names separated by commas from {', '.join(REGIMES)}")
    ap.add_argument("--accum", type=int, default=5)
    ap.add_argument("--measure_steps", type=int, default=3, help="timed optimizer updates")
    ap.add_argument("--enc_chunk", type=int, default=5)
    ap.add_argument("--remat", default="block", choices=["block", "sub"])
    ap.add_argument("--attention_impl", default="auto", choices=["auto", "xla", "pallas"])
    ap.add_argument("--out", default=None, help="also write the lines as a JSON list here")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="one regime: trace one more update into DIR")
    ap.add_argument("--tiny", action="store_true",
                    help="small configs (flops.model_configs), for the CPU tests")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    regimes = list(REGIMES) if args.regime == "all" else args.regime.split(",")
    unknown = [r for r in regimes if r not in REGIMES]
    if unknown:
        ap.error(f"unknown regimes {unknown}: choose from {list(REGIMES)}")
    if args.accum < 1 or args.measure_steps < 1:
        ap.error("--accum and --measure_steps must be at least 1")
    if args.profile and len(regimes) != 1:
        ap.error("--profile traces one regime")

    device, args.card, _, _ = bench.setup(args.device)
    set_attention_impl(args.attention_impl)
    size = TINY_SIZE if args.tiny else SIZE
    models = bench.build_models(device, ("unet", "ctrl", "vae", "clip"), tiny=args.tiny,
                                gradient_checkpointing=True, remat_granularity=args.remat)
    tflops = {}
    lines = []
    for regime in regimes:
        kind = REGIMES[regime][0]
        try:
            if kind not in tflops:
                tflops[kind] = flops.train_micro_step_flops(
                    kind, encode_chunk=args.enc_chunk, remat_granularity=args.remat,
                    tiny=args.tiny, device="cpu" if args.tiny else flops.META, **size) / 1e12
            line = bench_regime(models, regime, args, size, device, tflops[kind])
        except Exception as e:  # an out-of-memory or a fault: record it, go on to the next
            traceback.print_exc()
            line = {"regime": regime, "error": f"{type(e).__name__}: {str(e)[:2000]}"}
        for m in models.values():
            m.eval().requires_grad_(False)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(lines, fh, indent=1)
    return lines


def cli(argv=None) -> int:
    """``main``, then the exit code: 1 where a regime failed."""
    return 1 if any("error" in line for line in main(argv)) else 0


if __name__ == "__main__":
    sys.exit(cli())
