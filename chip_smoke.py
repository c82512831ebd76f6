"""Smoke run of the PyTorch port (ctrlv_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two serving paths at the full SVD-XT width with seeded
random bf16 weights, through its six hand-written CUDA kernels:

1. device: the card's name and power limit, torch and CUDA versions, the
   TF32 switches;
2. build: the kernels from ctrlv_tpu_torch/csrc with nvcc (sm_90a), one
   nvcc per source, all started together;
3. kernels: each kernel against its plain PyTorch version at the shapes the
   paths give it (and at ragged shapes): max abs error, and CUDA-event times
   of the kernel, its plain version and the one PyTorch library call that
   computes the same function, beside the least time the card could take;
4. small: the Box2Video sampler and the overall pipeline at a small config
   that still routes the kernels (head dim 64, 1024 latent tokens), in bf16
   on the card against the same weights and draws in f32 on the CPU;
5. step: one full-width ControlNet+UNet denoise step with all kernels, with
   each of K3, K4, K5, K8 switched off in turn, with K4 on its split path
   only, and with all plain;
6. sampler: two Box2Video requests: 25 frames at 512x320, CFG 1 -> 3, 25
   Euler steps, decode chunk 8, synthetic bbox frames;
7. overall: one two-stage request: five stage-1 candidates in one batch
   (30 steps, frames-major UNet), cleanup and IoU select on the card, then
   Box2Video on the winner (25 steps). The result's keys, shapes and ranges
   and every kernel's launch count are checked.

``python3 chip_smoke.py --profile [DIR]`` instead builds the models and
prints one step's device time by kind of kernel (torch.profiler; the table
by kernel goes to DIR, by default output/).

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
import torch.nn.functional as F

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
from ctrlv_tpu_torch.models import layers  # noqa: E402
from ctrlv_tpu_torch.models.transformer_st import TransformerSpatioTemporalModel  # noqa: E402
from ctrlv_tpu_torch.ops import _build, _launch, attention, group_norm, layer_norm, mha  # noqa: E402
from ctrlv_tpu_torch.pipelines import (  # noqa: E402
    GUIDANCE_PAIRS,
    OverallPipeline,
    StableVideoControlPipeline,
    VideoDiffusionPipeline,
)

H, W, FRAMES, CHUNK = 320, 512, 25, 8
STAGE1_STEPS, STAGE2_STEPS = 30, 25
# Frames of one clip per batched VAE decode call (SamplingConfig.max_decode_frames).
# None, the pipeline's default, decodes all full chunks at once: stage 1's 120
# frames in one call, which peaks at 61 GiB on an 80 GB card.
MAX_DECODE_FRAMES = None
UNET_CONFIG, VAE_CONFIG, CLIP_CONFIG = UNetSTConfig(), VAEConfig(), CLIPVisionConfig()
DEVICE = "cuda"
# The card's published peaks (NVIDIA H100 SXM): HBM bytes/s, dense bf16 tensor
# FLOP/s, f32 FLOP/s outside the tensor cores.
PEAK_BYTES, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12
# |kernel - plain| <= KERNEL_TOL * (1 + |plain|) elementwise: the attention
# kernels round P to bf16 at other places than their plain versions, the norm
# kernels sum in another order, and the output itself is bf16 (ulp 2^-8 relative).
KERNEL_TOL = 1e-2
STEP_TOL = 5e-2  # relative L2 of the step's prediction, kernels vs plain
# Small sampler, card (bf16) vs CPU (f32), on frames in [0, 1]: mean and max
# abs. bf16 alone moves them by ~0.005 and ~0.035 at this config.
SMALL_TOL = (0.02, 0.15)
SMALL_LATENT_TOL = 5e-2  # relative L2 of the small stage-1 latents, card vs CPU
SMALL_IOU_TOL = 0.02  # a near-tie between candidates may fall either way in bf16
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
    "small_mha_fm": dict(
        name="small_mha_attention_fm", route="cuda", source="ctrlv_tpu_torch/csrc/small_mha.cu",
        replaces="ctrlv_tpu/ops/mha.py:424",
    ),
    "group_norm": dict(
        name="group_norm", route="cuda", source="ctrlv_tpu_torch/csrc/group_norm.cu",
        replaces="ctrlv_tpu/ops/group_norm.py:96",
    ),
    "layer_norm": dict(
        name="layer_norm", route="cuda", source="ctrlv_tpu_torch/csrc/layer_norm.cu",
        replaces="ctrlv_tpu/ops/layer_norm.py:69",
    ),
    "flash": dict(
        name="flash_attention", route="cuda", source="ctrlv_tpu_torch/csrc/mha.cu",
        replaces="ctrlv_tpu/ops/flash_attention.py:83",
    ),
}
# (kernel, shapes and options, timed: a shape of the two serving paths).
# Attention: q is (B, Sq, H*D) [flash: (B, Sq, H, D)], k and v have sk rows.
# A batch of 50 is the Box2Video step (CFG 2 x 25 frames), 250 the stage-1
# step (2 x 5 candidates x 25 frames); the step phase's frames-major variant
# gives K3 its batch of 50.
KERNEL_CASES = [
    ("mha", dict(shape=(50, 2560, 320), heads=5), True),
    ("mha", dict(shape=(250, 2560, 320), heads=5), True),
    ("mha", dict(shape=(2, 1100, 256), heads=2), False),  # ragged tiles, head dim 128
    ("small_mha", dict(shape=(5120, 25, 320), heads=5), True),
    ("small_mha", dict(shape=(1280, 25, 640), heads=10), True),
    ("small_mha", dict(shape=(320, 25, 1280), heads=20), True),
    ("small_mha", dict(shape=(300, 40, 256), heads=2), False),  # frames padded to 64, d 128
    ("small_mha_fm", dict(shape=(50, 2560, 320), heads=5, frames=25), True),
    ("small_mha_fm", dict(shape=(50, 640, 640), heads=10, frames=25), True),
    ("small_mha_fm", dict(shape=(50, 160, 1280), heads=20, frames=25), True),
    ("small_mha_fm", dict(shape=(250, 2560, 320), heads=5, frames=25), True),
    ("small_mha_fm", dict(shape=(250, 640, 640), heads=10, frames=25), True),
    ("small_mha_fm", dict(shape=(250, 160, 1280), heads=20, frames=25), True),
    ("small_mha_fm", dict(shape=(250, 40, 1280), heads=20, frames=25), True),  # mid block
    ("small_mha_fm", dict(shape=(80, 151, 256), heads=2, frames=40), False),  # odd S, d 128
    ("flash", dict(shape=(50, 640, 10, 64)), True),
    ("flash", dict(shape=(50, 160, 20, 64)), True),  # 2.5 tiles of 64 query rows
    ("flash", dict(shape=(250, 640, 10, 64)), True),
    ("flash", dict(shape=(250, 160, 20, 64)), True),
    ("flash", dict(shape=(3, 200, 2, 128), sk=130), False),  # Sq != Sk, ragged, d 128
    ("group_norm", dict(shape=(50, 320, 40, 64), act="silu"), True),
    ("group_norm", dict(shape=(50, 320, 40, 64), act=None), True),
    ("group_norm", dict(shape=(50, 1280, 20, 32), act="silu"), True),
    ("group_norm", dict(shape=(50, 2560, 5, 8), act="silu"), True),
    ("group_norm", dict(shape=(2, 320, 25, 40, 64), act="silu"), True),  # temporal ResBlock
    ("group_norm", dict(shape=(250, 320, 40, 64), act="silu"), True),
    ("group_norm", dict(shape=(250, 1280, 20, 32), act="silu"), True),
    ("group_norm", dict(shape=(250, 2560, 5, 8), act="silu"), True),
    ("group_norm", dict(shape=(10, 320, 25, 40, 64), act="silu"), True),
    # The VAE at 512x320: the decoder takes all full chunks of a batch in one
    # call (24 frames of one clip, 120 of five), the encoder stage 1's 125
    # bbox frames; the decoder's temporal ResBlocks see clips of one chunk.
    ("group_norm", dict(shape=(24, 128, 320, 512), act="silu"), True),
    ("group_norm", dict(shape=(120, 128, 320, 512), act="silu"), True),
    ("group_norm", dict(shape=(125, 128, 320, 512), act="silu"), True),
    ("group_norm", dict(shape=(15, 128, 8, 320, 512), act="silu"), True),
    ("group_norm", dict(shape=(2, 33, 7, 9), act="silu", groups=3), False),  # run of 693
    ("group_norm", dict(shape=(2, 6, 251, 163), act=None, groups=2), False),  # run of 122 739
    ("layer_norm", dict(shape=(128000, 320)), True),
    ("layer_norm", dict(shape=(32000, 640)), True),
    ("layer_norm", dict(shape=(8000, 1280)), True),
    ("layer_norm", dict(shape=(640000, 320)), True),
    ("layer_norm", dict(shape=(160000, 640)), True),
    ("layer_norm", dict(shape=(40000, 1280)), True),
    ("layer_norm", dict(shape=(10000, 1280)), True),  # mid block, 40 tokens a frame
    ("layer_norm", dict(shape=(257, 1280)), False),  # CLIP's rows: an odd count
]
# Launches of the attention kernels in one forward at full width: K1 at the
# 2560-token level; K8 at 640 and 160 tokens; the temporal kernel at the three
# levels with 256 pixels or more in the batch, and in the mid block (40 tokens a
# frame) from a batch of 7 clips on.
ATTN_PER_FORWARD = {
    "unet": dict(mha=5, flash=10, temporal=15),
    "ctrl": dict(mha=2, flash=4, temporal=6),
}


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_time_ms(fn, reps: int = 7, warmup: int = 2, inner: int = 1) -> float:
    """Median of ``reps`` CUDA-event timings of ``inner`` back-to-back calls of
    ``fn``, per call, after ``warmup`` calls. With ``inner`` > 1 the host
    prepares a launch while the card runs the one before, as on the paths,
    so a short kernel's time is not the host's time to launch it."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} count {torch.cuda.device_count()} card {card}")
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


def make_case(kind: str, spec: dict, gen):
    """(kernel, plain, library) closures over fresh inputs on the card, and
    the bytes the function must move and the operations it does."""
    def randn(shape):
        return torch.randn(shape, generator=gen, device=DEVICE, dtype=torch.bfloat16)

    shape = spec["shape"]
    if kind in ("mha", "small_mha", "small_mha_fm", "flash"):
        if kind == "flash":
            b, sq, heads, d = shape
        else:
            b, sq, hd = shape
            heads = spec["heads"]
            d = hd // heads
        sk = spec.get("sk", sq)
        kv_shape = (b, sk) + tuple(shape[2:])
        q, k, v = randn(shape), randn(kv_shape), randn(kv_shape)
        scale = d**-0.5
        nbytes = 2 * (2 * q.numel() + 2 * k.numel())
        if kind == "small_mha_fm":
            f = spec["frames"]
            flops = 4 * b * sq * f * heads * d  # B*F*S rows, F keys each
            kern = lambda: mha.small_mha_attention_fm(q, k, v, heads, scale, f)  # noqa: E731
            plain = lambda: mha.small_mha_attention_fm_plain(q, k, v, heads, scale, f)  # noqa: E731

            def view(x):  # (B*F, S, H*D) -> (B, S, H, F, D), a view
                return x.view(b // f, f, sq, heads, d).permute(0, 2, 3, 1, 4)

            lib = lambda: F.scaled_dot_product_attention(view(q), view(k), view(v), scale=scale)  # noqa: E731
        else:
            flops = 4 * b * sq * sk * heads * d
            if kind == "flash":
                kern = lambda: attention.flash_attention(q, k, v, scale)  # noqa: E731
                plain = lambda: attention.flash_attention_plain(q, k, v, scale)  # noqa: E731
            else:
                fn, fn_plain = {
                    "mha": (mha.mha_attention, mha.mha_attention_plain),
                    "small_mha": (mha.small_mha_attention, mha.small_mha_attention_plain),
                }[kind]
                kern = lambda: fn(q, k, v, heads, scale)  # noqa: E731
                plain = lambda: fn_plain(q, k, v, heads, scale)  # noqa: E731

            def view(x):  # -> (B, H, S, D), a view
                return x.view(b, x.shape[1], heads, d).transpose(1, 2)

            lib = lambda: F.scaled_dot_product_attention(view(q), view(k), view(v), scale=scale)  # noqa: E731
        return kern, plain, lib, nbytes, flops, PEAK_BF16

    x = 1.5 * randn(shape) + 0.3
    c = shape[1] if kind == "group_norm" else shape[-1]
    weight = (1.0 + 0.2 * torch.randn(c, generator=gen, device=DEVICE)).bfloat16()
    bias = (0.2 * torch.randn(c, generator=gen, device=DEVICE)).bfloat16()
    nbytes = 2 * (2 * x.numel() + 2 * c)
    if kind == "group_norm":
        groups, act = spec.get("groups", 32), spec["act"]
        kern = lambda: group_norm.group_norm(x, weight, bias, groups, 1e-5, act)  # noqa: E731
        plain = lambda: group_norm.group_norm_plain(x, weight, bias, groups, 1e-5, act)  # noqa: E731

        def lib():
            y = F.group_norm(x, groups, weight, bias, 1e-5)
            return F.silu(y) if act == "silu" else y

        flops = (12 if act == "silu" else 8) * x.numel()
    else:
        kern = lambda: layer_norm.layer_norm(x, weight, bias, 1e-5)  # noqa: E731
        plain = lambda: layer_norm.layer_norm_plain(x, weight, bias, 1e-5)  # noqa: E731
        lib = lambda: F.layer_norm(x, (c,), weight, bias, 1e-5)  # noqa: E731
        flops = 8 * x.numel()
    return kern, plain, lib, nbytes, flops, PEAK_F32


def compare(out, ref):
    """Max abs error of ``out`` against ``ref`` and whether every element lies
    within KERNEL_TOL * (1 + |ref|); in slices, so that the f32 copies of a
    multi-GB output stay small."""
    rows = max(1, (1 << 27) // max(1, out[0].numel()))
    err, within = 0.0, True
    for o, r in zip(out.split(rows), ref.split(rows)):
        r = r.float()
        diff = (o.float() - r).abs()
        err = max(err, diff.max().item())
        within = within and bool((diff <= KERNEL_TOL * (1.0 + r.abs())).all())
    return err, within


def split_only(fn):
    """``fn()`` while K4 sends every run down its split path, short ones too."""
    keep = group_norm._SMEM_RUN_ELEMS
    group_norm._SMEM_RUN_ELEMS = 0
    try:
        return fn()
    finally:
        group_norm._SMEM_RUN_ELEMS = keep


def phase_kernels() -> dict:
    """Each kernel against its plain version on the same inputs; the timed
    cases also beside the library call and the card's bound."""
    keys = ("errs", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    results = {k: {key: [] for key in keys} for k in KERNELS}
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    for kind, spec, timed in KERNEL_CASES:
        kern, plain, lib, nbytes, flops, rate = make_case(kind, spec, gen)
        before = _launch.LAUNCHES[kind]
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        if _launch.LAUNCHES[kind] != before + 1:
            fail(f"{kind} at {spec} did not launch its kernel")
        err, within = compare(out, ref)
        line = (f"[kernels] {kind} {spec} max_abs_err={err:.3e} "
                f"tol={KERNEL_TOL}*(1+|plain|) within={within}")
        res = results[kind]
        if timed:
            t_bytes, t_ops = 1e3 * nbytes / PEAK_BYTES, 1e3 * flops / rate
            times = dict(ms=cuda_time_ms(kern, inner=8), plain_ms=cuda_time_ms(plain, inner=8),
                         library_ms=cuda_time_ms(lib, inner=8), bound_ms=max(t_bytes, t_ops))
            for key, val in times.items():
                res[key].append(val)
            res["bound_by"].append("bytes" if t_bytes >= t_ops else "operations")
            line += (f" kernel_ms={times['ms']:.4f} plain_ms={times['plain_ms']:.4f} "
                     f"library_ms={times['library_ms']:.4f} bound_ms={times['bound_ms']:.4f} "
                     f"(bytes {t_bytes:.4f}, operations {t_ops:.4f})")
            if (kind == "group_norm"
                    and out[0].numel() // spec.get("groups", 32) <= group_norm._SMEM_RUN_ELEMS):
                # A run short enough for the one-block path: the split path beside it.
                err_split, ok = compare(split_only(kern), ref)
                within = within and ok
                line += (f" split_path_ms={split_only(lambda: cuda_time_ms(kern, inner=8)):.4f} "
                         f"(max_abs_err {err_split:.3e})")
        print(line, flush=True)
        res["errs"].append(err)
        if not (bool(torch.isfinite(out).all()) and within):
            fail(f"{kind} at {spec} disagrees with its plain version: {err}")
        del out, ref, kern, plain, lib
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
    """Full-width models on the card: the Box2Video UNet and ControlNet, the
    stage-1 UNet (frames-major), and the VAE and CLIP that both stages share."""
    t0 = time.perf_counter()
    with torch.device(DEVICE):
        models = {
            "unet": UNetSpatioTemporalConditionModel(UNET_CONFIG),
            "ctrl": ControlNetSpatioTemporal(UNET_CONFIG),
            "vae": AutoencoderKLTemporalDecoder(VAE_CONFIG),
            "clip": CLIPVisionModelWithProjection(CLIP_CONFIG),
            "unet1": UNetSpatioTemporalConditionModel(UNET_CONFIG, temporal_layout="frames_major"),
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


def set_temporal_layout(nets, layout: str) -> None:
    for net in nets:
        for m in net.modules():
            if isinstance(m, TransformerSpatioTemporalModel):
                m.temporal_layout = layout


def count_modules(net, cls) -> int:
    return sum(isinstance(m, cls) for m in net.modules())


def decode_calls(frames: int, chunk: int, max_frames) -> int:
    """Calls of the VAE decoder that decode_latents makes for one batch."""
    n_full, rem = divmod(frames, chunk)
    per_call = max(1, min(n_full, max_frames // chunk)) if max_frames else n_full
    return (-(-n_full // per_call) if n_full else 0) + (1 if rem else 0)


def expected_launches(models, forwards: dict, temporal: dict) -> dict:
    """Launches a path should make. ``forwards``: calls of each net (for the
    VAE its encoder and decoder apart); ``temporal``: for each UNet or
    ControlNet the temporal kernel it takes and whether its batch puts the
    mid block over the kernel's gate of 256 pixels."""
    nets = dict(models, enc=models["vae"].encoder, dec=models["vae"].decoder)
    exp = dict.fromkeys(_launch.LAUNCHES, 0)
    for key, calls in forwards.items():
        exp["group_norm"] += calls * count_modules(nets[key], layers.GroupNorm)
        exp["layer_norm"] += calls * count_modules(nets[key], layers.LayerNorm)
        kind = "ctrl" if key == "ctrl" else "unet" if key.startswith("unet") else None
        if kind:
            per = ATTN_PER_FORWARD[kind]
            name, mid = temporal[key]
            exp["mha"] += calls * per["mha"]
            exp["flash"] += calls * per["flash"]
            exp[name] += calls * (per["temporal"] + (1 if mid else 0))
    return exp


def make_step(models):
    """A full-width ControlNet+UNet denoise step on seeded inputs (CFG batch
    2 x 25 frames), as a closure, and its latent height and width."""
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    ucfg = models["unet"].config
    h, w = H // VAE_CONFIG.spatial_scale, W // VAE_CONFIG.spatial_scale
    lat = torch.randn((2, FRAMES, h, w, ucfg.in_channels), generator=gen, device=DEVICE)
    cond = torch.randn((2, FRAMES, h, w, 4), generator=gen, device=DEVICE)
    emb = torch.randn((2, 1, ucfg.cross_attention_dim), generator=gen, device=DEVICE)
    tids = torch.tensor([[6.0, 127.0, 0.02]] * 2, device=DEVICE)
    t = torch.tensor(0.25 * np.log(10.0), device=DEVICE)

    @torch.no_grad()
    def step():
        down, mid = models["ctrl"](lat, t, emb, tids, cond)
        return models["unet"](lat, t, emb, tids, down_block_additional_residuals=down,
                              mid_block_additional_residuals=mid).float()

    return step, h, w


@torch.no_grad()
def phase_step(models) -> None:
    """One full-width ControlNet+UNet step: all six kernels' worth (the
    frames-major layout puts K3 in K2's place), each newer kernel switched
    off in turn, and all plain. In turns, forwards and backwards."""
    step, h, w = make_step(models)
    nets = (models["ctrl"], models["unet"])

    def run(variant: str, fn):
        """``fn`` under one variant's switches, which are put back after."""
        if variant == "K4 split":
            return split_only(lambda: run("all kernels", fn))
        set_temporal_layout(nets, "seq" if variant == "K3 off" else "frames_major")
        group_norm.set_fused_group_norm(variant != "K4 off")
        layer_norm.set_fused_layer_norm(variant != "K5 off")
        attention.set_attention_impl("xla" if variant == "K8 off" else "auto")
        try:
            if variant == "all plain":
                with _launch.plain_kernels():
                    return fn()
            return fn()
        finally:
            set_temporal_layout(nets, "seq")
            group_norm.set_fused_group_norm(True)
            layer_norm.set_fused_layer_norm(True)
            attention.set_attention_impl("auto")

    variants = ("all kernels", "K3 off", "K4 off", "K4 split", "K5 off", "K8 off", "all plain")
    _launch.reset_launch_counts()
    preds = {v: run(v, step) for v in ("all kernels", "all plain")}
    torch.cuda.synchronize()
    counts = dict(_launch.LAUNCHES)
    expect = expected_launches(models, {"ctrl": 1, "unet": 1},
                               {"ctrl": ("small_mha_fm", False), "unet": ("small_mha_fm", False)})
    if counts != expect:
        fail(f"one step launched {counts}, expected {expect}")

    samples = {v: [] for v in variants}
    for order in (variants, variants[::-1]):
        for v in order:
            samples[v].append(run(v, lambda: cuda_time_ms(step, reps=3, warmup=1)))
    ms = {v: float(np.mean(samples[v])) for v in variants}
    pred, pred_plain = preds["all kernels"], preds["all plain"]
    rel = ((pred - pred_plain).norm() / pred_plain.norm()).item()
    err = (pred - pred_plain).abs().max().item()
    print(f"[step] ControlNet+UNet, batch 2x{FRAMES} at {h}x{w}, ms (mean of two medians of 3, "
          f"taken in turns): " + ", ".join(f"{v} {ms[v]:.1f}" for v in variants), flush=True)
    print("[step] the two medians: " + ", ".join(
        f"{v} {samples[v][0]:.1f}/{samples[v][1]:.1f}" for v in variants))
    print(f"[step] all kernels vs all plain: rel_l2={rel:.3e} (tol {STEP_TOL}) "
          f"max_abs_err={err:.3e} |pred|max={pred_plain.abs().max().item():.3e}; "
          f"launches {counts}", flush=True)
    if not (torch.isfinite(pred).all() and rel <= STEP_TOL):
        fail(f"kernel step differs from the plain step: rel_l2 {rel}")


@torch.no_grad()
def phase_small_reference() -> None:
    """The sampler and the overall pipeline at a small config that still
    routes the kernels, on the card in bf16 and on the CPU in f32 (plain
    versions), from the same weights and the same draws."""
    frames, h, w, steps = 5, 64, 64, 2
    n = len(GUIDANCE_PAIRS)
    cpu = {
        "unet": UNetSpatioTemporalConditionModel(SMALL_UNET),
        "ctrl": ControlNetSpatioTemporal(SMALL_UNET),
        "vae": AutoencoderKLTemporalDecoder(VAEConfig.tiny()),
        "clip": CLIPVisionModelWithProjection(CLIPVisionConfig.tiny()),
        "unet1": UNetSpatioTemporalConditionModel(SMALL_UNET, temporal_layout="frames_major"),
    }
    for seed, m in enumerate(cpu.values(), start=10):
        init_random_(m, seed)
        m.eval()
    card = {k: copy.deepcopy(m).to(DEVICE, torch.bfloat16) for k, m in cpu.items()}
    rng = np.random.default_rng(5)
    draw = lambda *shape: torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))  # noqa: E731
    normal = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    image, cond = draw(1, h, w, 3), draw(1, frames, h, w, 3)
    scale = VAEConfig.tiny().spatial_scale
    lat_shape = (frames, h // scale, w // scale, 4)
    noise2 = (normal(1, h, w, 3), normal(1, *lat_shape))
    noise1 = (normal(n, h, w, 3), normal(n, *lat_shape))
    kw = dict(num_frames=frames, num_inference_steps=steps, decode_chunk_size=2)

    def pipes(models, device):
        ctrl = StableVideoControlPipeline(models["unet"], models["ctrl"], models["vae"],
                                          models["clip"], device=device)
        bbox = VideoDiffusionPipeline(models["unet1"], models["vae"], models["clip"],
                                      device=device)
        return ctrl, bbox

    def run_sampler(models, device):
        ctrl, _ = pipes(models, device)
        return ctrl(image, cond, image_noise=noise2[0], latents=noise2[1], **kw).cpu()

    def run_overall(models, device):
        ctrl, bbox = pipes(models, device)
        lat = bbox(image.repeat(n, 1, 1, 1), cond.repeat(n, 1, 1, 1, 1),
                   guidance_minmax=torch.tensor(GUIDANCE_PAIRS), image_noise=noise1[0],
                   latents=noise1[1], output_type="latent", **kw).cpu()
        res = OverallPipeline(bbox, ctrl)(
            image[0], cond[0], num_frames=frames, stage1_steps=steps, stage2_steps=steps,
            decode_chunk_size=2, stage1_noise=noise1, stage2_noise=noise2)
        return lat, res

    def frame_errors(out, ref):
        diff = (torch.as_tensor(out) - torch.as_tensor(ref)).abs()
        return diff.mean().item(), diff.max().item()

    ref = run_sampler(cpu, "cpu")
    _launch.reset_launch_counts()
    out = run_sampler(card, DEVICE)
    counts = dict(_launch.LAUNCHES)
    mean_err, max_err = frame_errors(out, ref)
    print(f"[small] sampler {frames}x{h}x{w}, {steps} steps: card bf16 vs cpu f32 "
          f"mean_abs={mean_err:.3e} max_abs={max_err:.3e} (tol {SMALL_TOL}), "
          f"launches {counts}", flush=True)
    if (counts["mha"], counts["small_mha"]) != (7 * steps, 14 * steps):
        fail(f"small sampler launched {counts}")
    if not (torch.isfinite(out).all() and mean_err <= SMALL_TOL[0] and max_err <= SMALL_TOL[1]):
        fail("small sampler on the card differs from its f32 reference")

    lat_ref, res_ref = run_overall(cpu, "cpu")
    _launch.reset_launch_counts()
    lat, res = run_overall(card, DEVICE)
    counts = dict(_launch.LAUNCHES)
    rel = ((lat - lat_ref).norm() / lat_ref.norm()).item()
    mean_err, max_err = frame_errors(res["video"], res_ref["video"])
    print(f"[small] overall {n} candidates {frames}x{h}x{w}, {steps}+{steps} steps: card bf16 "
          f"vs cpu f32 stage-1 latents rel_l2={rel:.3e} (tol {SMALL_LATENT_TOL}), chosen "
          f"{res['best_guidance']} vs {res_ref['best_guidance']}, miou {res['miou']:.4f} vs "
          f"{res_ref['miou']:.4f}, video mean_abs={mean_err:.3e} max_abs={max_err:.3e}, "
          f"launches {counts}", flush=True)
    if any(v == 0 for v in counts.values()):
        fail(f"small overall did not reach every kernel: {counts}")
    if not (torch.isfinite(lat).all() and rel <= SMALL_LATENT_TOL):
        fail("small stage-1 latents on the card differ from their f32 reference")
    same = res["best_guidance"] == res_ref["best_guidance"]
    if not same and abs(res["miou"] - res_ref["miou"]) > SMALL_IOU_TOL:
        fail("small overall chose another candidate than its f32 reference, and no near-tie")
    if same and not (mean_err <= SMALL_TOL[0] and max_err <= SMALL_TOL[1]):
        fail("small overall video on the card differs from its f32 reference")


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
    return torch.from_numpy(image[None]), torch.from_numpy(frames[None])


def check_clip(name: str, out, shape) -> None:
    out = torch.as_tensor(out)
    finite = bool(torch.isfinite(out).all())
    lo, hi = out.min().item(), out.max().item()
    if tuple(out.shape) != shape or not finite or lo < 0.0 or hi > 1.0:
        fail(f"{name}: shape {tuple(out.shape)}, finite {finite}, range [{lo}, {hi}]")


def check_launches(name: str, counts: dict, expect: dict) -> None:
    if counts != expect:
        fail(f"{name} launched {counts}, expected {expect}")


def phase_sampler(models, card: str) -> dict:
    """Two Box2Video requests (the first slice's main path); the second shows
    the time without the first call's set-up."""
    pipe = StableVideoControlPipeline(models["unet"], models["ctrl"], models["vae"],
                                      models["clip"])
    expect = expected_launches(
        models,
        {"clip": 1, "enc": 2, "dec": decode_calls(FRAMES, CHUNK, None),
         "ctrl": STAGE2_STEPS, "unet": STAGE2_STEPS},
        {"ctrl": ("small_mha", False), "unet": ("small_mha", False)},
    )
    for seed in (1, 2):
        image, cond = synthetic_request(seed)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        _launch.reset_launch_counts()
        t0 = time.perf_counter()
        out = pipe(image, cond, generator=torch.Generator(device=DEVICE).manual_seed(seed),
                   num_frames=FRAMES, num_inference_steps=STAGE2_STEPS, min_guidance_scale=1.0,
                   max_guidance_scale=3.0, decode_chunk_size=CHUNK)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(_launch.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"[sampler] seed {seed}: {tuple(out.shape)} in [{out.min().item():.3f}, "
              f"{out.max().item():.3f}] std {out.std().item():.3f}, {secs:.3f} s/clip, "
              f"max_memory_allocated {peak:.2f} GiB, launches {counts}; card {card}", flush=True)
        check_clip("the Box2Video clip", out, (1, FRAMES, H, W, 3))
        check_launches("the Box2Video request", counts, expect)
    return counts


def phase_overall(models, card: str) -> dict:
    """One two-stage request with the JAX package's defaults (this slice's
    main path): five candidates, 30 + 25 steps, decode chunk 8."""
    bbox = VideoDiffusionPipeline(models["unet1"], models["vae"], models["clip"])
    ctrl = StableVideoControlPipeline(models["unet"], models["ctrl"], models["vae"],
                                      models["clip"])
    pipe = OverallPipeline(bbox, ctrl)
    image, cond = synthetic_request(2)

    # Time the stages through the pipelines' own calls; the select is the rest.
    stage_secs = {}

    def timed(name, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stage_secs[name] = time.perf_counter() - t0
            return out
        return call

    pipe.bbox_pipeline = timed("stage1", bbox)
    pipe.ctrl_pipeline = timed("stage2", ctrl)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _launch.reset_launch_counts()
    t0 = time.perf_counter()
    res = pipe(image[0], cond[0], generator=torch.Generator(device=DEVICE).manual_seed(2),
               num_frames=FRAMES, stage1_steps=STAGE1_STEPS, stage2_steps=STAGE2_STEPS,
               decode_chunk_size=CHUNK, max_decode_frames=MAX_DECODE_FRAMES)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(_launch.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    select = secs - stage_secs["stage1"] - stage_secs["stage2"]
    print(f"[overall] {len(GUIDANCE_PAIRS)} candidates x {FRAMES} frames at {W}x{H}: "
          f"{secs:.3f} s/request = stage 1 {stage_secs['stage1']:.3f} s ({STAGE1_STEPS} steps, "
          f"UNet batch {2 * len(GUIDANCE_PAIRS)}x{FRAMES}) + select {select:.3f} s + stage 2 "
          f"{stage_secs['stage2']:.3f} s ({STAGE2_STEPS} steps); max_decode_frames "
          f"{MAX_DECODE_FRAMES}; max_memory_allocated {peak:.2f} GiB; card {card}", flush=True)
    print(f"[overall] best_guidance {res['best_guidance']} miou {res['miou']:.4f} ap "
          f"{res['ap']:.4f} ar {res['ar']:.4f} first/last {res['miou_first_last']:.4f}; "
          f"launches {counts}", flush=True)

    keys = {"video", "bbox_video", "miou", "ap", "ar", "miou_first_last", "ap_first_last",
            "ar_first_last", "best_guidance"}
    if set(res) != keys:
        fail(f"overall result has keys {sorted(res)}")
    check_clip("the overall video", res["video"], (FRAMES, H, W, 3))
    check_clip("the overall bbox video", res["bbox_video"], (FRAMES, H, W, 3))
    if res["best_guidance"] not in GUIDANCE_PAIRS:
        fail(f"best_guidance {res['best_guidance']}")
    scores = [res[k] for k in sorted(keys - {"video", "bbox_video", "best_guidance"})]
    if not all(isinstance(s, float) and 0.0 <= s <= 1.0 for s in scores):
        fail(f"overall scores {scores}")
    n = len(GUIDANCE_PAIRS)
    expect = expected_launches(
        models,
        {"clip": 2, "enc": 4, "ctrl": STAGE2_STEPS, "unet": STAGE2_STEPS, "unet1": STAGE1_STEPS,
         "dec": decode_calls(FRAMES, CHUNK, MAX_DECODE_FRAMES) * 2},
        {"ctrl": ("small_mha", False), "unet": ("small_mha", False),
         "unet1": ("small_mha_fm", 2 * n * 40 >= 256)},
    )
    check_launches("the overall request", counts, expect)
    return counts


# Kinds of device kernel by a word of the name torch.profiler reports; the
# first kind with a match wins.
KERNEL_KINDS = (
    ("K2 + K3 (small_mha.cu)", ("small_mha_fwd_kernel",)),
    ("K1 + K8 (mha.cu)", ("mha_fwd_kernel",)),
    ("K4 (group_norm.cu)", ("namespace)::gn_",)),
    ("K5 (layer_norm.cu)", ("namespace)::layer_norm_kernel",)),
    ("cuDNN NCHW<->NHWC transforms", ("nchwToNhwc", "nhwcToNchw")),
    ("convolutions (cuDNN)", ("cudnn", "implicit_gemm", "conv")),
    ("matmuls (cuBLAS)", ("nvjet", "gemm", "cutlass")),
    ("copies and casts", ("copy", "Memcpy", "CatArray")),
    ("softmax and reductions", ("softmax", "reduce")),
    ("elementwise (adds, muls, gelu, SiLU)", ("elementwise",)),
)


@torch.no_grad()
def profile_step(models, card: str, out_dir: str) -> None:
    """A reading, not a check: the device time of one ControlNet+UNet step by
    kind of kernel (torch.profiler); the table by kernel goes to
    ``out_dir``/step_profile.txt."""
    from torch.profiler import ProfilerActivity, profile

    step, _, _ = make_step(models)
    set_temporal_layout((models["ctrl"], models["unet"]), "frames_major")
    ms = cuda_time_ms(step, reps=3, warmup=2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    by_kind, total, n_kernels = {}, 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.self_device_time_total
        kind = next((k for k, words in KERNEL_KINDS if any(w in evt.key for w in words)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + us
        total += us
        n_kernels += evt.count
    if total <= 0:
        fail("the profiler recorded no device time")
    print(f"[profile] one step, all kernels, frames-major: {ms:.1f} ms by CUDA events; "
          f"{n_kernels} device kernels, {total / 1e3:.1f} ms of device time; card {card}")
    for kind, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {kind}: {us / 1e3:.1f} ms, {100 * us / total:.1f} %")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "step_profile.txt"), "w") as fh:
        fh.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=80,
                                           max_name_column_width=90))


def main() -> None:
    t_start = time.perf_counter()
    card = phase_device()
    phase_build()
    if sys.argv[1:2] == ["--profile"] and len(sys.argv) <= 3:
        profile_step(build_models(), card, sys.argv[2] if len(sys.argv) == 3 else "output")
        return
    if sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]}")
    kernels = phase_kernels()
    phase_small_reference()
    models = build_models()
    phase_step(models)
    paths = {"box2video": phase_sampler(models, card), "overall": phase_overall(models, card)}

    rows = []
    for kind, meta in KERNELS.items():
        res = kernels[kind]
        by = res["bound_by"]
        rows.append(dict(
            meta, launches=sum(p[kind] for p in paths.values()),
            launches_by_path={name: p[kind] for name, p in paths.items()},
            max_abs_err=max(res["errs"]),
            ms=float(np.mean(res["ms"])), plain_ms=float(np.mean(res["plain_ms"])),
            bound_ms=float(np.mean(res["bound_ms"])),
            bound_by=by[0],  # of the first, largest shape
            library_ms=float(np.mean(res["library_ms"])),
        ))
        # Each kernel belongs to the overall path; the earlier path runs all but K3.
        if paths["overall"][kind] == 0 or (kind != "small_mha_fm" and not paths["box2video"][kind]):
            fail(f"{kind} was not launched on its path: {rows[-1]['launches_by_path']}")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)  # name, power limit
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
