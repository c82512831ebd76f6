"""Smoke run of the PyTorch port (ctrlv_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the Box2Video sampler of the port at the full SVD-XT width with
seeded random bf16 weights, through its hand-written CUDA kernels:

1. device: the card's name and power limit, torch and CUDA versions, the
   TF32 switches;
2. build: the kernels from ctrlv_tpu_torch/csrc with nvcc (sm_90a);
3. each kernel against its plain PyTorch version at the sampler's shapes
   (and at ragged shapes): max abs error, and CUDA-event times;
4. a small sampler whose attention takes both kernels (head dim 64, 1024
   latent tokens), in bf16 on the card against the same weights and draws
   in f32 on the CPU;
5. one full-width ControlNet+UNet denoise step through the kernels and
   through the plain versions;
6. two requests to the sampler: 25 frames at 512x320, CFG 1 -> 3, 25 Euler
   steps, decode chunk 8, each with its own seed and synthetic bbox frames;
   the output's shape and range and the kernels' launch counts are checked.

Prints a JSON line of the kernels, then, as the last line,
{"ok": true, "device": {...}}. A failed check exits non-zero before that
line. Without a CUDA device, or without the repository beside it, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ctrlv_tpu_torch.models import (  # noqa: E402
    AutoencoderKLTemporalDecoder,
    CLIPVisionConfig,
    CLIPVisionModelWithProjection,
    ControlNetSpatioTemporal,
    UNetSpatioTemporalConditionModel,
    UNetSTConfig,
    VAEConfig,
)
from ctrlv_tpu_torch.ops import _build, mha  # noqa: E402
from ctrlv_tpu_torch.pipelines import StableVideoControlPipeline  # noqa: E402

H, W, FRAMES, STEPS, CHUNK = 320, 512, 25, 25, 8
UNET_CONFIG, VAE_CONFIG, CLIP_CONFIG = UNetSTConfig(), VAEConfig(), CLIPVisionConfig()
SEEDS = (1, 2)
DEVICE = "cuda"
K1_PER_STEP, K2_PER_STEP = 7, 21
# |kernel - plain| <= KERNEL_TOL * (1 + |plain|) elementwise: the two round P
# to bf16 at other places, and the output itself is bf16 (ulp 2^-8 relative).
KERNEL_TOL = 1e-2
STEP_TOL = 5e-2  # relative L2 of the step's prediction, kernels vs plain
# Small sampler, card (bf16) vs CPU (f32), on frames in [0, 1]: mean and max
# abs. bf16 alone moves them by ~0.005 and ~0.035 at this config.
SMALL_TOL = (0.02, 0.15)
SMALL_UNET = UNetSTConfig(
    block_out_channels=(64, 64, 64, 64), num_attention_heads=(1, 1, 1, 1),
    cross_attention_dim=48, addition_time_embed_dim=16, projection_class_embeddings_input_dim=48,
)

KERNELS = {
    "mha": dict(
        name="mha_attention", route="cuda", source="ctrlv_tpu_torch/csrc/mha.cu",
        replaces="ctrlv_tpu/ops/mha.py:183",
    ),
    "small_mha": dict(
        name="small_mha_attention", route="cuda", source="ctrlv_tpu_torch/csrc/small_mha.cu",
        replaces="ctrlv_tpu/ops/mha.py:294",
    ),
}
# (kernel, operand shape (B or N, S or F, H*D), heads, on the sampler's path)
KERNEL_CASES = [
    ("mha", (50, 2560, 320), 5, True),
    ("small_mha", (5120, 25, 320), 5, True),
    ("small_mha", (1280, 25, 640), 10, True),
    ("small_mha", (320, 25, 1280), 20, True),
    ("mha", (2, 1100, 256), 2, False),  # ragged tiles, head dim 128
    ("small_mha", (300, 40, 256), 2, False),  # frames padded to 64, head dim 128
]
KERNEL_FNS = {
    "mha": (mha.mha_attention, mha.mha_attention_plain),
    "small_mha": (mha.small_mha_attention, mha.small_mha_attention_plain),
}


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_time_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card)  # name, power limit
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} count {torch.cuda.device_count()}")
    # The bf16 sampler's only f32 matmuls take bf16 values upcast (attention
    # logits), which TF32 holds exactly; its convs all run in bf16.
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    print(f"[device] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return card


def phase_build() -> None:
    _build.load()
    info = _build.build_info
    print(f"[build] nvcc {'built' if info['built'] else 'loaded'} {info['path']} "
          f"in {info['seconds']:.1f} s")
    for line in info["log"].splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build]   {line.strip()}")


def phase_kernels() -> dict:
    """Each kernel against its plain version on the same inputs."""
    results = {k: {"errs": [], "ms": [], "plain_ms": []} for k in KERNEL_FNS}
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    for kind, shape, heads, on_path in KERNEL_CASES:
        q, k, v = (torch.randn(shape, generator=gen, device=DEVICE, dtype=torch.bfloat16)
                   for _ in range(3))
        scale = (shape[-1] // heads) ** -0.5
        kern, plain = KERNEL_FNS[kind]
        out = kern(q, k, v, heads, scale)
        ref = plain(q, k, v, heads, scale)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        within = bool((diff <= KERNEL_TOL * (1.0 + ref.float().abs())).all())
        line = (f"[kernels] {kind} {shape}/{heads} max_abs_err={err:.3e} "
                f"tol={KERNEL_TOL}*(1+|plain|) within={within}")
        if on_path:
            ms = cuda_time_ms(lambda: kern(q, k, v, heads, scale))
            plain_ms = cuda_time_ms(lambda: plain(q, k, v, heads, scale))
            results[kind]["ms"].append(ms)
            results[kind]["plain_ms"].append(plain_ms)
            line += f" kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}"
        print(line, flush=True)
        results[kind]["errs"].append(err)
        if not (bool(torch.isfinite(out).all()) and within):
            fail(f"{kind} at {shape}/{heads} disagrees with its plain version: {err}")
        del q, k, v, out, ref, diff
    torch.cuda.empty_cache()
    return results


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


def build_models():
    t0 = time.perf_counter()
    with torch.device(DEVICE):
        models = {
            "unet": UNetSpatioTemporalConditionModel(UNET_CONFIG),
            "ctrl": ControlNetSpatioTemporal(UNET_CONFIG),
            "vae": AutoencoderKLTemporalDecoder(VAE_CONFIG),
            "clip": CLIPVisionModelWithProjection(CLIP_CONFIG),
        }
    n_params = 0
    for seed, (key, m) in enumerate(models.items(), start=100):
        init_random_(m, seed)
        models[key] = m.to(torch.bfloat16).eval().requires_grad_(False)
        n_params += sum(p.numel() for p in m.parameters())
    torch.cuda.synchronize()
    print(f"[models] {n_params / 1e9:.3f} B params in bf16 on the card, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    return models


@torch.no_grad()
def phase_step(models) -> dict:
    """One full-width ControlNet+UNet step, kernels vs plain versions."""
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    ucfg = models["unet"].config
    h, w = H // VAE_CONFIG.spatial_scale, W // VAE_CONFIG.spatial_scale
    lat = torch.randn((2, FRAMES, h, w, ucfg.in_channels), generator=gen, device=DEVICE)
    cond = torch.randn((2, FRAMES, h, w, 4), generator=gen, device=DEVICE)
    emb = torch.randn((2, 1, ucfg.cross_attention_dim), generator=gen, device=DEVICE)
    tids = torch.tensor([[6.0, 127.0, 0.02]] * 2, device=DEVICE)
    t = torch.tensor(0.25 * np.log(10.0), device=DEVICE)

    def step():
        down, mid = models["ctrl"](lat, t, emb, tids, cond)
        return models["unet"](lat, t, emb, tids, down_block_additional_residuals=down,
                              mid_block_additional_residuals=mid).float()

    mha.reset_launch_counts()
    pred = step()
    torch.cuda.synchronize()
    counts = dict(mha.LAUNCHES)
    if counts != {"mha": K1_PER_STEP, "small_mha": K2_PER_STEP}:
        fail(f"one step launched {counts}, expected {K1_PER_STEP} and {K2_PER_STEP}")
    with mha.plain_attention():
        pred_plain = step()
        plain_ms = cuda_time_ms(step, reps=3, warmup=0)
    ms = cuda_time_ms(step, reps=3, warmup=1)
    rel = ((pred - pred_plain).norm() / pred_plain.norm()).item()
    err = (pred - pred_plain).abs().max().item()
    print(f"[step] ControlNet+UNet, batch 2x{FRAMES} at {h}x{w}: kernels {ms:.1f} ms, "
          f"plain {plain_ms:.1f} ms; rel_l2={rel:.3e} (tol {STEP_TOL}) max_abs_err={err:.3e} "
          f"|pred|max={pred_plain.abs().max().item():.3e}", flush=True)
    if not (torch.isfinite(pred).all() and rel <= STEP_TOL):
        fail(f"kernel step differs from the plain step: rel_l2 {rel}")
    return {"ms": ms, "plain_ms": plain_ms, "rel_l2": rel}


@torch.no_grad()
def phase_small_reference() -> None:
    """The sampler at a small config that still routes both kernels, on the
    card in bf16 and on the CPU in f32 (plain versions), from the same
    weights and the same draws."""
    frames, h, w, steps = 5, 64, 64, 2
    cpu = {
        "unet": UNetSpatioTemporalConditionModel(SMALL_UNET),
        "ctrl": ControlNetSpatioTemporal(SMALL_UNET),
        "vae": AutoencoderKLTemporalDecoder(VAEConfig.tiny()),
        "clip": CLIPVisionModelWithProjection(CLIPVisionConfig.tiny()),
    }
    for seed, m in enumerate(cpu.values(), start=10):
        init_random_(m, seed)
        m.eval()
    card = {k: copy.deepcopy(m).to(DEVICE, torch.bfloat16) for k, m in cpu.items()}
    rng = np.random.default_rng(5)
    draw = lambda *shape: torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))  # noqa: E731
    image, cond = draw(1, h, w, 3), draw(1, frames, h, w, 3)
    scale = VAEConfig.tiny().spatial_scale
    noise = torch.from_numpy(rng.standard_normal((1, h, w, 3)).astype(np.float32))
    lat = torch.from_numpy(
        rng.standard_normal((1, frames, h // scale, w // scale, 4)).astype(np.float32))
    kw = dict(num_frames=frames, num_inference_steps=steps, decode_chunk_size=2)

    def run(models, device):
        pipe = StableVideoControlPipeline(models["unet"], models["ctrl"], models["vae"],
                                          models["clip"])
        to = lambda t: t.to(device)  # noqa: E731
        return pipe(to(image), to(cond), image_noise=to(noise), latents=to(lat), **kw).cpu()

    ref = run(cpu, "cpu")
    mha.reset_launch_counts()
    out = run(card, DEVICE)
    counts = dict(mha.LAUNCHES)
    diff = (out - ref).abs()
    mean_err, max_err = diff.mean().item(), diff.max().item()
    print(f"[small] sampler {frames}x{h}x{w}, {steps} steps: card bf16 vs cpu f32 "
          f"mean_abs={mean_err:.3e} max_abs={max_err:.3e} (tol {SMALL_TOL}), "
          f"launches {counts}", flush=True)
    if counts != {"mha": 7 * steps, "small_mha": 14 * steps}:
        fail(f"small sampler launched {counts}")
    if not (torch.isfinite(out).all() and mean_err <= SMALL_TOL[0] and max_err <= SMALL_TOL[1]):
        fail("small sampler on the card differs from its f32 reference")


def synthetic_request(seed: int):
    """A first frame and 25 bbox frames in [-1, 1], drawn with numpy: three
    boxes moving across a dark frame, outlined in their own colours."""
    rng = np.random.default_rng(seed)
    frames = np.full((FRAMES, H, W, 3), -1.0, np.float32)
    for _ in range(3):
        bw, bh = rng.uniform(W / 12, W / 4), rng.uniform(H / 10, H / 4)
        x0, y0 = rng.uniform(0, W - bw), rng.uniform(0, H - bh)
        dx, dy = rng.uniform(-W, W) / 150, rng.uniform(-H, H) / 150
        colour = rng.uniform(-0.5, 1.0, size=3).astype(np.float32)
        for f in range(FRAMES):
            x1 = int(np.clip(x0 + dx * f, 0, W - bw - 1))
            y1 = int(np.clip(y0 + dy * f, 0, H - bh - 1))
            x2, y2 = x1 + int(bw), y1 + int(bh)
            frames[f, y1:y2, x1:x1 + 2] = colour
            frames[f, y1:y2, x2 - 2:x2] = colour
            frames[f, y1:y1 + 2, x1:x2] = colour
            frames[f, y2 - 2:y2, x1:x2] = colour
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, size=3)
    image = np.stack(
        [np.sin(xx / 37.0 + phase[c]) * np.cos(yy / 23.0 - phase[c]) for c in range(3)], -1
    ).astype(np.float32) * 0.8
    to_dev = lambda a: torch.from_numpy(a).to(DEVICE)  # noqa: E731
    return to_dev(image[None]), to_dev(frames[None])


def phase_sampler(models, card: str) -> dict:
    pipe = StableVideoControlPipeline(models["unet"], models["ctrl"], models["vae"],
                                      models["clip"])
    total = {"mha": 0, "small_mha": 0}
    times = []
    torch.cuda.reset_peak_memory_stats()
    for seed in SEEDS:
        image, cond = synthetic_request(seed)
        torch.cuda.synchronize()
        mha.reset_launch_counts()
        t0 = time.perf_counter()
        out = pipe(image, cond, generator=torch.Generator(device=DEVICE).manual_seed(seed),
                   num_frames=FRAMES, num_inference_steps=STEPS, min_guidance_scale=1.0,
                   max_guidance_scale=3.0, decode_chunk_size=CHUNK)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(mha.LAUNCHES)
        times.append(secs)
        for k in total:
            total[k] += counts[k]
        expect = {"mha": K1_PER_STEP * STEPS, "small_mha": K2_PER_STEP * STEPS}
        finite = bool(torch.isfinite(out).all())
        lo, hi = out.min().item(), out.max().item()
        print(f"[sampler] seed {seed}: {tuple(out.shape)} in [{lo:.3f}, {hi:.3f}] "
              f"std {out.std().item():.3f}, {secs:.3f} s/clip, launches {counts}", flush=True)
        if tuple(out.shape) != (1, FRAMES, H, W, 3) or not finite or lo < 0.0 or hi > 1.0:
            fail(f"clip of seed {seed}: shape {tuple(out.shape)}, finite {finite}, "
                 f"range [{lo}, {hi}]")
        if counts != expect:
            fail(f"clip of seed {seed} launched {counts}, expected {expect}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[sampler] s/clip {times[0]:.3f} (first request), {times[1]:.3f} (second); "
          f"max_memory_allocated {peak:.2f} GiB; card {card}", flush=True)
    return total


def main() -> None:
    t_start = time.perf_counter()
    card = phase_device()
    phase_build()
    kernels = phase_kernels()
    phase_small_reference()
    models = build_models()
    phase_step(models)
    launches = phase_sampler(models, card)

    rows = []
    for kind, meta in KERNELS.items():
        res = kernels[kind]
        rows.append(dict(
            meta, launches=launches[kind], max_abs_err=max(res["errs"]),
            ms=float(np.mean(res["ms"])), plain_ms=float(np.mean(res["plain_ms"])),
        ))
    print(json.dumps({"kernels": rows}))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
