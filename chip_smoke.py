"""Smoke run of the PyTorch port (ctrlv_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two serving paths, its ControlNet and stage-1 training
steps, its overall-eval entry point, its three trainer entry points, its
evaluation-metric commands, its measurement tools and its teaser and data
commands at the full SVD-XT width with seeded random bf16 weights, the AR
bbox baseline's two commands and the legacy models at their published
widths, through its eight hand-written CUDA kernels:

1. device: the card's name and power limit, torch and CUDA versions, the
   TF32 switches;
2. build: the kernels from ctrlv_tpu_torch/csrc with nvcc (sm_90a), one
   nvcc per source, all started together; then, per kernel of csrc/mha.cu
   (K1 and K8), csrc/geglu_ff.cu (K6) and per convolution kernel of
   csrc/resblock.cu (K7), its count of wgmma (HGMMA), TMA load (UTMALDG)
   and mma.sync (HMMA) instructions in the built library's SASS;
3. kernels: each kernel against its plain PyTorch version at the shapes the
   paths give it (and at ragged shapes): max abs error (K1 and K4-K8 also
   run twice and must agree to the bit; K4-K7 print their plans, K7 shows
   its cache of re-laid weights at work), and CUDA-event times of the
   kernel, its plain version and the one PyTorch library call that computes
   the same function, beside the least time the card could take; for K2-K5
   and their library calls also the device time apart from the host's
   (the calls queued behind a sleep of the card, tools/timing.py) and the
   host's µs to enqueue one call; each of K4's three paths forced in turn
   at a shape of short runs and one of long runs, where it can take it, and
   its SiLU on each path within one bf16 ulp of the plain version's at
   normalised values in [-10, 0];
   then each kernel under autograd at a shape of the training step: its
   output against the plain version's, and its gradient through the wrapper
   against the gradient through the function it recomputes with alone;
4. small: the Box2Video sampler and the overall pipeline at a small config
   that still routes the kernels (head dim 64, 1024 latent tokens), in bf16
   on the card against the same weights and draws in f32 on the CPU;
5. step: one full-width ControlNet+UNet denoise step with all default
   kernels, with each of K3, K4, K5 switched off in turn, under
   --attention_impl xla (the library's attention at every attention site:
   no launch of K1, K2, K3 or K8), with K4 forced onto each of its paths in
   turn (where the path can take the shape), with K6 (on by default)
   switched off, with K7 (off by default) switched on, and with all plain;
6. sampler: two timed Box2Video requests: 25 frames at 512x320, CFG 1 -> 3,
   25 Euler steps, decode chunk 8, synthetic bbox frames; then a third,
   untimed, under the shape hooks (below);
7. overall: a two-stage request: five stage-1 candidates in one batch
   (30 steps, frames-major UNet), cleanup and IoU select on the card, then
   Box2Video on the winner (25 steps); once with K6 on (its default) and
   once with K6 off, for its A/B, then once more with K6 on, untimed, under
   the shape hooks. The result's keys, shapes and ranges and every kernel's
   launch count are checked;
8. train: the ControlNet training step on one clip of 25 frames at 512x320
   ("seq" layout, block checkpointing, encode chunk 5, AdamW with a bf16
   first moment): a warm-up micro-step, two optimizer updates at
   accumulation 2 with K6 on (it takes the feed-forwards that want no
   gradient: the frozen UNet's down blocks'), then one micro-step each with
   K6 on, K6 off and all plain from the same parameters and draws, and six
   more timings of each in turns for K6's A/B. Loss, gradients, which
   parameters moved and when, and every kernel's launch count are checked;
8b. dist (after [train], on the serving models): the multi-card paths at
   world 1, a process group of one NCCL rank in this process: three
   Box2Video steps through the sampler's mesh= path and one ControlNet
   micro-step with its AdamW update through the data-parallel step (ZeRO-1
   asked for), each against the same call without a mesh (bit-equal
   latents, loss, gradient norm and parameters, the same kernel launches,
   the collective counters of ctrlv_tpu_torch.parallel above zero), then
   tools.dryrun_multichip with one spawned rank. The card's machine has one
   GPU: two or more ranks run only on the CPU (gloo) in the tests;
9. train_svd: the stage-1 training step in the temporal regime (the bbox
   predictor: only the temporal transformer blocks train, as a partitioned
   subset) on one clip, with the same layout, checkpointing, encode chunk and
   optimizer: a warm-up micro-step, two updates at accumulation 2 with K7
   on, then one micro-step each with K7 on, K7 off and all plain; the same
   checks, and that nothing outside the subset moved or asked for a gradient.
   Then one full-finetune update at accumulation 2, for its peak memory, and
   one VAE-decoder step on 8 frames;
10. eval: the overall-eval entry point (ctrlv_tpu_torch.tools.eval_overall),
   once the models above are freed: seeded random bf16 UNet-ST, VAE and CLIP
   written as a diffusers directory by the port's save_pipeline (GB and
   seconds printed), built from it by the tool's build_models (strict; every
   loaded tensor equal to the written one bit for bit), then the tool's loop
   over two synthetic clips (25 frames at 512x320) from get_dataloader with
   two worker processes, 30 + 25 steps, decode chunk 8, its GIFs exported
   where PIL imports. Each request's seconds, loader wait, export seconds,
   scores and peak memory are printed; its outputs and scores are checked, and its launches
   must be [overall]'s with K3's taken by K2 (one "seq" UNet serves both
   stages, as in the JAX tool);
11. train_cli: the three trainer entry points (ctrlv_tpu_torch.tools.train_*)
   through each tool's own train(cfg, models, loader), on models its
   build_models loads from a seeded random bf16 checkpoint, under f32 master
   weights, on synthetic clips of 25 frames at 512x320 ("seq" layout, block
   checkpointing, encode chunk 5, AdamW with a bf16 first moment at lr 1e-5):
   the ControlNet trainer at accumulation 2 for 4 micro-steps, with a
   training-state checkpoint at micro-step 2 and at the end and one
   validation on one demo sample (5 Euler steps, not 25), then resumed from
   the latest checkpoint by a second run from fresh models for 2 more (the
   restored state must equal the saved one bit for bit), its f32 export built
   back strictly and equal to the masters bit for bit; the stage-1 trainer
   (the bbox predictor, full finetune, EMA) for two updates at accumulation 2;
   the VAE trainer for one step on 8 frames. The stage-1 trainer's checkpoint
   and exports are counted and timed up to the host copy, not written: the
   card's machine charges every byte written to its disk, deleted or not,
   against a limit (one checkpoint, written by [eval], serves [eval],
   [train_cli] and [eval_metrics] for the same reason). Each micro-step's launches must
   be a [train] micro-step's (ControlNet) or the count predicted from the
   module counts (stage 1), the validation's those of a sampler of 5 steps;
   s/micro-step, s/update, the checkpoint's GB with its write and restore
   GB/s, peak memory and how many trained tensors moved in master and in bf16
   at each update are printed;
12. eval_metrics: the evaluation-metric commands on models built by the
   tools' build_models from a seeded random bf16 checkpoint: the stage-1 eval
   (ctrlv_tpu_torch.tools.eval_video_bbox_prediction) and the generation eval
   (tools.eval_video_generation, with its FVD) over two synthetic clips each
   (25 frames at 512x320, 25 steps, CFG 1 -> 3, decode chunk 8, two loader
   workers), each clip's frames, scores and launches (a 25-step stage-1
   sampler's) checked, s/clip, scoring, export and peak memory printed; the
   I3D alone at its published widths on a 25-frame clip at 224x224 in f32,
   timed beside its bound (FLOPs by FlopCounterMode) and with TF32 on; then
   the offline eval (metrics.offline_eval) of the exported directory with
   seeded I3D and LPIPS weights at the JAX defaults, its seconds split into
   GIF decode and the rest, and the card's I3D features and LPIPS distances
   held against the same modules on the CPU in f32 (and how far TF32 would
   move them);
13. bench: the measurement tools (ctrlv_tpu_torch.tools.bench, bench_train,
   profile_denoise), each run as a user runs it, in a process of its own
   with a time limit, after [train_svd] has freed the models and before
   [eval] writes its checkpoint: ``tools.bench --workload overall --runs 2``
   (its Box2Video line and its overall line), ``tools.bench_train --regime
   controlnet,lora,full --accum 5 --measure_steps 1`` and
   ``tools.profile_denoise --steps 2``. Each JSON line is printed; every one
   must hold its keys with finite values and an MFU in (0, 1), the Box2Video
   clip's launches must be [sampler]'s and the overall request's [overall]'s,
   and a clip's FLOPs the count that tests/test_torch_bench.py pins;
14. teaser: after [eval_metrics], on a nuScenes tree the phase writes (one
   scene of 49 CAM_FRONT JPEGs at 1600x900 and 12 Hz with five moving
   instances: one validation clip of 25 frames at 7 Hz) and a small DAVIS
   tree: tools.preprocess_dataset (25 box frames at 512x320, by token),
   tools.dataset_examples (synthetic and DAVIS present, their batches on
   the card), then tools.draw_teaser on models its build_models loads from
   [eval]'s checkpoint: two overall requests (seeds 9, 10; the tool's third
   seed is cut for the time limit; 30 + 25 steps, decode chunk 8, two
   loader workers), each request's launches
   [eval]'s, its GIFs, overlays and 1600x900 ground-truth plots checked;
   s/request, the loader's first wait, a clip's host seconds, export and
   plot seconds and peak memory printed.

15. baseline (after [train_svd], on its models): the AR bbox baseline's
   commands as a user runs them at the default BaselineConfig (batch 2, 25
   timesteps x 15 agents, hidden 256, 2 + 4 layers) on the synthetic dataset
   at 512x320, in a working directory of its own: tools.train_bbox_baseline
   for 40 steps, then tools.eval_bbox_baseline on 4 clips from the checkpoint
   it wrote; s/step (median and spread), first and last loss, checkpoint MB
   with a save's and a restore's seconds (restored tensors bit-equal), s a
   rollout, render and export seconds, the scores and peak memory; the
   card's loss of a fixed batch within 1e-4 of the CPU's in IEEE f32; then
   the baseline's ImageEncoder once on a 512x320 frame over the VAE and CLIP,
   its K4 and K5 launches those of a VAE encode and a CLIP forward;
16. legacy: the legacy models at their published widths with seeded random
   bf16 weights: the UNet2D with both object hooks at SD1.x width (batch 2,
   64x64 latents, 77 text tokens, 16 object tokens from KittiObjectNet over a
   collated synthetic batch), encode_bbox_frame of the bbox-cond UNet-ST at
   SVD-XT's config (25 frames, 8 layers, width 2500) and LayoutNet's
   generate_step at GPT-2 base width (f32, 22 steps): each one's launches
   against its routed sites (K4, K5 and K6 on the UNet2D), all kernels
   against all plain within 5e-2 relative L2, ms a call in turns, peak
   memory; the encoded objects must not move encode_bbox_frame.

``python3 chip_smoke.py --profile [DIR]`` instead builds the models and
prints one step's device time by kind of kernel and by kernel
(tools.profile_denoise over torch.profiler; the tables by kernel go to DIR,
by default output/), with K7 off and on in turns, then K6 off and on.

Forward hooks on every GroupNorm and LayerNorm count K4's and K5's launches
by input shape on five paths (an extra, untimed Box2Video request and
overall request; the untimed warm-up ControlNet and stage-1 temporal
micro-steps; an extra, untimed UNet2D forward), printed as one table
(``[shapes]``) before the end.

Prints a JSON line of the kernels, then, as the last line,
{"ok": true, "device": {...}}. A failed check exits non-zero before that
line. Without a CUDA device, or without the repository beside it, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ctrlv_tpu_torch.baseline import BaselineConfig, ImageEncoder, process_data  # noqa: E402
from ctrlv_tpu_torch.data import get_dataloader  # noqa: E402
from ctrlv_tpu_torch.metrics.common import ieee_f32  # noqa: E402
from ctrlv_tpu_torch.models import (  # noqa: E402
    AutoencoderKLTemporalDecoder,
    CLIPVisionConfig,
    CLIPVisionModelWithProjection,
    ControlNetSpatioTemporal,
    KittiObjectNet,
    LayoutNet,
    LayoutNetConfig,
    UNet2DConditionModel,
    UNet2DConfig,
    UNetSpatioTemporalConditionModel,
    UNetSpatioTemporalConditionModelWithBBoxCond,
    UNetSTConfig,
    VAEConfig,
)
from ctrlv_tpu_torch.models import layers  # noqa: E402
from ctrlv_tpu_torch.models.resnet import ResnetBlock2D  # noqa: E402
from ctrlv_tpu_torch.ops import (  # noqa: E402
    _build, _launch, attention, geglu_ff, group_norm, layer_norm, mha, resblock,
)
from ctrlv_tpu_torch.parallel import (  # noqa: E402
    COLLECTIVES, make_mesh, make_train_mesh, reset_collective_counts, shard_train_state,
)
from ctrlv_tpu_torch.pipelines import (  # noqa: E402
    GUIDANCE_PAIRS,
    OverallPipeline,
    StableVideoControlPipeline,
    VideoDiffusionPipeline,
)
from ctrlv_tpu_torch.tools import bench, profile_denoise  # noqa: E402
from ctrlv_tpu_torch.tools import common as tool_common  # noqa: E402
from ctrlv_tpu_torch.tools import (  # noqa: E402
    eval_bbox_baseline, eval_overall, eval_video_bbox_prediction, eval_video_generation,
    train_bbox_baseline, train_vae_finetuning, train_video_controlnet, train_video_diffusion,
)
from ctrlv_tpu_torch.tools.timing import device_ms  # noqa: E402
from ctrlv_tpu_torch.train import (  # noqa: E402
    CheckpointManager,
    MasterWeights,
    MultiSteps,
    init_train_state,
    load_hf_component,
    make_controlnet_train_step,
    make_optimizer,
    make_svd_train_step,
    make_vae_decoder_train_step,
    save_pipeline,
    split_trainable,
    temporal_blocks_predicate,
    vae_decoder_predicate,
)
from ctrlv_tpu_torch.utils.config import Config  # noqa: E402
from ctrlv_tpu_torch.utils.objectnet import generate_step  # noqa: E402
from ctrlv_tpu_torch.utils.safetensors_io import iter_tensors  # noqa: E402

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
SMS = 132  # its streaming multiprocessors
# kernels whose plain versions `[kernels]` times with fewer calls (K1, K6, K7)
SLOW_PLAIN = ("mha", "geglu_ff", "resblock")
# kernels (K2-K5) whose device time `[kernels]` reads apart from the host's, beside
# their library calls': their calls are short enough for the host to hold the card back
DEVICE_TIMED = ("small_mha", "small_mha_fm", "group_norm", "layer_norm")
# |kernel - plain| <= KERNEL_TOL * (1 + |plain|) elementwise: the attention
# kernels round P to bf16 at other places than their plain versions, the norm
# kernels sum in another order, and the output itself is bf16 (ulp 2^-8 relative).
KERNEL_TOL = 1e-2
STEP_TOL = 5e-2  # relative L2 of the step's prediction, kernels vs plain
# A gradient through a wrapper is the gradient of the plain version at the
# same inputs: relative L2, a few bf16 ulps of reduction order.
GRAD_TOL = 1e-2
# The training micro-step, kernels against all plain, from the same parameters
# and draws: bf16 activations through 40-odd checkpointed layers forward and
# back, each kernel a few bf16 ulps from its plain version; the loss relative,
# the gradients in relative L2 over all ControlNet parameters.
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 5e-2, 1e-1
ENCODE_CHUNK, ACCUM = 5, 2
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
    "geglu_ff": dict(
        name="geglu_ff", route="cuda", source="ctrlv_tpu_torch/csrc/geglu_ff.cu",
        replaces="ctrlv_tpu/ops/geglu_ff.py:226",
    ),
    "resblock": dict(
        name="fused_resblock2d", route="cuda", source="ctrlv_tpu_torch/csrc/resblock.cu",
        replaces="ctrlv_tpu/ops/resblock.py:258",
    ),
}
# (kernel, shapes and options, timed: a shape of one of the three paths).
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
    ("flash", dict(shape=(50, 160, 20, 64)), True),  # 1.25 tiles of 128: the 64-row plan
    ("flash", dict(shape=(250, 640, 10, 64)), True),
    ("flash", dict(shape=(250, 160, 20, 64)), True),
    ("flash", dict(shape=(3, 200, 2, 128), sk=130), False),  # Sq != Sk, ragged, d 128
    # Risky for K1 and K8's TMA tiles: a ragged 128-row tile at batch 3 (no row
    # of the next element may come in), more keys than queries, and three full
    # 64-row tiles (where 128-row tiles would leave the second half empty).
    ("mha", dict(shape=(3, 1000, 320), heads=5), False),
    ("mha", dict(shape=(2, 1024, 320), heads=5, sk=2048), False),
    ("flash", dict(shape=(3, 192, 10, 64)), False),
    ("group_norm", dict(shape=(50, 320, 40, 64), act="silu"), True),
    ("group_norm", dict(shape=(50, 320, 40, 64), act=None), True),
    ("group_norm", dict(shape=(50, 1280, 20, 32), act="silu"), True),
    ("group_norm", dict(shape=(50, 2560, 5, 8), act="silu"), True),
    ("group_norm", dict(shape=(2, 320, 25, 40, 64), act="silu"), True),  # temporal ResBlock
    ("group_norm", dict(shape=(250, 320, 40, 64), act="silu"), True),
    ("group_norm", dict(shape=(250, 1280, 20, 32), act="silu"), True),
    ("group_norm", dict(shape=(250, 2560, 5, 8), act="silu"), True),
    ("group_norm", dict(shape=(10, 320, 25, 40, 64), act="silu"), True),
    # The deeper levels, the most launched of K4's shapes (PERF.md, launches by shape):
    # spatial at the Box2Video step's batch and stage 1's, temporal at their clips
    ("group_norm", dict(shape=(50, 640, 20, 32), act="silu"), True),
    ("group_norm", dict(shape=(50, 1280, 10, 16), act="silu"), True),
    ("group_norm", dict(shape=(50, 1280, 5, 8), act="silu"), True),
    ("group_norm", dict(shape=(250, 640, 20, 32), act="silu"), True),
    ("group_norm", dict(shape=(250, 1280, 10, 16), act="silu"), True),
    ("group_norm", dict(shape=(250, 1280, 5, 8), act="silu"), True),
    ("group_norm", dict(shape=(2, 640, 25, 20, 32), act="silu"), True),
    ("group_norm", dict(shape=(2, 1280, 25, 10, 16), act="silu"), True),
    ("group_norm", dict(shape=(2, 1280, 25, 5, 8), act="silu"), True),
    ("group_norm", dict(shape=(10, 640, 25, 20, 32), act="silu"), True),
    ("group_norm", dict(shape=(10, 1280, 25, 10, 16), act="silu"), True),
    ("group_norm", dict(shape=(10, 1280, 25, 5, 8), act="silu"), True),
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
    ("layer_norm", dict(shape=(2000, 1280)), True),  # mid block of the Box2Video step
    ("layer_norm", dict(shape=(257, 1280)), False),  # CLIP's rows: an odd count
    ("layer_norm", dict(shape=(999, 1288)), False),  # 32 lanes x 6 vectors, the last ragged
    ("layer_norm", dict(shape=(3003, 72)), False),  # 2 lanes a row, 16 rows a warp
    # K6, rows x width (inner = 4 x width): the training micro-step (1 x 25
    # frames), the Box2Video step, stage 1; then the same with the LayerNorm in front.
    ("geglu_ff", dict(shape=(64000, 320)), True),
    ("geglu_ff", dict(shape=(16000, 640)), True),
    ("geglu_ff", dict(shape=(128000, 320)), True),
    ("geglu_ff", dict(shape=(32000, 640)), True),
    ("geglu_ff", dict(shape=(640000, 320)), True),
    ("geglu_ff", dict(shape=(160000, 640)), True),
    ("geglu_ff", dict(shape=(64000, 320), ln=True), True),
    ("geglu_ff", dict(shape=(16000, 640), ln=True), True),
    ("geglu_ff", dict(shape=(128000, 320), ln=True), True),
    ("geglu_ff", dict(shape=(32000, 640), ln=True), True),
    ("geglu_ff", dict(shape=(1001, 320)), False),  # ragged rows: 7 tiles of 128 and 105 rows
    ("geglu_ff", dict(shape=(999, 640), ln=True), False),
    ("geglu_ff", dict(shape=(100, 320)), False),  # less than one tile of 128 rows
    ("geglu_ff", dict(shape=(129, 640), ln=True), False),  # two tiles of 64 rows and one row
    # The training micro-step (one clip: a batch of 25 frames, "seq" layout)
    # for the older kernels. K2 runs at the two levels with 256 pixels or more;
    # the VAE encoder takes chunks of 5 frames and the first frame alone.
    ("mha", dict(shape=(25, 2560, 320), heads=5), True),
    ("small_mha", dict(shape=(2560, 25, 320), heads=5), True),
    ("small_mha", dict(shape=(640, 25, 640), heads=10), True),
    ("flash", dict(shape=(25, 640, 10, 64)), True),
    ("flash", dict(shape=(25, 160, 20, 64)), True),
    ("group_norm", dict(shape=(25, 320, 40, 64), act="silu"), True),
    ("group_norm", dict(shape=(25, 320, 40, 64), act=None), True),
    ("group_norm", dict(shape=(25, 1280, 20, 32), act="silu"), True),
    ("group_norm", dict(shape=(25, 2560, 5, 8), act="silu"), True),
    ("group_norm", dict(shape=(1, 320, 25, 40, 64), act="silu"), True),  # temporal ResBlock
    ("group_norm", dict(shape=(5, 128, 320, 512), act="silu"), True),
    ("group_norm", dict(shape=(1, 128, 320, 512), act="silu"), True),
    ("layer_norm", dict(shape=(64000, 320)), True),
    ("layer_norm", dict(shape=(16000, 640)), True),
    ("layer_norm", dict(shape=(4000, 1280)), True),
    ("layer_norm", dict(shape=(1000, 1280)), True),  # mid block
    # The legacy UNet2D at SD1.x width (batch 2 at 64x64 latents): K4 on 4096-pixel
    # planes (10 channels a group at C = 320) and on the up path's skip concatenations,
    # K5 at its token rows, K6 at M = 8192 and 2048; the bbox attention's GroupNorm of
    # 4 groups of one channel; TextTimeEmbedding's LayerNorms.
    ("group_norm", dict(shape=(2, 320, 64, 64), act="silu"), True),
    ("group_norm", dict(shape=(2, 320, 64, 64), act=None), True),
    ("group_norm", dict(shape=(2, 960, 64, 64), act="silu"), True),
    ("group_norm", dict(shape=(2, 640, 32, 32), act="silu"), True),
    ("group_norm", dict(shape=(2, 1920, 32, 32), act="silu"), True),
    ("group_norm", dict(shape=(2, 1280, 16, 16), act="silu"), True),
    ("group_norm", dict(shape=(2, 2560, 8, 8), act="silu"), True),
    ("group_norm", dict(shape=(1, 4, 40, 64), act=None, groups=4), True),
    ("layer_norm", dict(shape=(8192, 320)), True),
    ("layer_norm", dict(shape=(2048, 640)), True),
    ("layer_norm", dict(shape=(512, 1280)), True),
    ("layer_norm", dict(shape=(32, 768)), True),
    ("geglu_ff", dict(shape=(8192, 320)), True),
    ("geglu_ff", dict(shape=(2048, 640)), True),
    # K7, (N, C, H, W) of a same-channel spatial ResBlock: the Box2Video step, the
    # training micro-step and stage 1 at level 0; the deeper levels (a tile spans
    # several samples at 10x16 and 5x8) at the Box2Video step's batch, the training
    # micro-step's and stage 1's (should it be routed there); a small ragged one.
    ("resblock", dict(shape=(50, 320, 40, 64)), True),
    ("resblock", dict(shape=(25, 320, 40, 64)), True),
    ("resblock", dict(shape=(250, 320, 40, 64)), True),
    ("resblock", dict(shape=(50, 640, 20, 32)), True),
    ("resblock", dict(shape=(50, 1280, 10, 16)), True),
    ("resblock", dict(shape=(50, 1280, 5, 8)), True),
    ("resblock", dict(shape=(25, 640, 20, 32)), True),
    ("resblock", dict(shape=(25, 1280, 10, 16)), True),
    ("resblock", dict(shape=(25, 1280, 5, 8)), True),
    ("resblock", dict(shape=(250, 640, 20, 32)), True),
    ("resblock", dict(shape=(250, 1280, 10, 16)), True),
    ("resblock", dict(shape=(250, 1280, 5, 8)), True),
    ("resblock", dict(shape=(3, 320, 11, 16)), False),  # 8 image rows a tile: 3 of the second
]
# A case a kernel for the gradient check: a shape of the training micro-step
# (K7 at its first level and at its deepest, where the last tile is ragged).
GRAD_CASES = [
    ("mha", dict(shape=(25, 2560, 320), heads=5)),
    ("small_mha", dict(shape=(2560, 25, 320), heads=5)),
    ("small_mha_fm", dict(shape=(25, 2560, 320), heads=5, frames=25)),
    ("flash", dict(shape=(25, 640, 10, 64))),
    ("group_norm", dict(shape=(25, 320, 40, 64), act="silu")),
    ("layer_norm", dict(shape=(64000, 320))),
    ("geglu_ff", dict(shape=(64000, 320))),
    ("geglu_ff", dict(shape=(16000, 640), ln=True)),
    ("resblock", dict(shape=(25, 320, 40, 64))),
    ("resblock", dict(shape=(25, 1280, 5, 8))),
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
    card = bench.card_name(torch.device("cuda", 0))  # name, power limit by nvidia-smi
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
    # K1 and K8 (csrc/mha.cu), K6 (csrc/geglu_ff.cu) and K7's convolutions
    # (csrc/resblock.cu) are wgmma products fed by TMA: every instantiation
    # has HGMMA and UTMALDG in its SASS, and no HMMA (mma.sync).
    sass = subprocess.run([_build.cuda_tool("cuobjdump"), "-sass", info["path"]],
                          capture_output=True, text=True, timeout=300)
    if sass.returncode != 0:
        fail(f"cuobjdump -sass failed: {sass.stderr[-2000:]}")
    ops, fn = ("HGMMA", "UTMALDG", "HMMA"), None
    counts = {"mha.cu": {}, "geglu_ff.cu": {}, "resblock.cu": {}}
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            fn = None
            m = re.search(r"14mha_fwd_kernelI((?:Li\d+E)+)E", line)
            if m:
                fn = ("mha.cu", "mha_fwd_kernel<" + ",".join(re.findall(r"\d+", m.group(1)))
                      + "> (D, consumer warpgroups, keys a tile, stages)")
            m = re.search(r"15geglu_ff_kernelINS0_3CfgIL((?:i\d+EL)+)b([01])EEELb([01])EE", line)
            if m:
                c, s1, s2 = re.findall(r"\d+", m.group(1))
                fn = ("geglu_ff.cu", f"geglu_ff_kernel<C {c}, {s1} W1 / {s2} W2 stages, "
                      f"ping-pong {m.group(2)}, LayerNorm {m.group(3)}>")
            m = re.search(r"11conv_kernelILb([01])ELi(\d+)EE", line)
            if m:
                fn = ("resblock.cu", f"conv_kernel<{('conv2', 'conv1')[int(m.group(1))]}, "
                      f"{160 * int(m.group(2))} output channels a block>")
            if fn:
                counts[fn[0]][fn[1]] = dict.fromkeys(ops, 0)
        elif fn:
            for op in ops:
                counts[fn[0]][fn[1]][op] += len(re.findall(rf"\b{op}\b", line))
    for source, by_fn in counts.items():
        for name, cnt in by_fn.items():
            print(f"[build] {source} {name}: " + ", ".join(f"{op} {n}" for op, n in cnt.items()))
        if len(by_fn) < (1 if source == "mha.cu" else 4) or any(
                not c["HGMMA"] or not c["UTMALDG"] or c["HMMA"] for c in by_fn.values()):
            fail(f"{source}'s kernels are not wgmma + TMA throughout: {by_fn}")


def make_case(kind: str, spec: dict, gen):
    """(kernel, plain, library) closures over fresh inputs on the card, the
    bytes the function must move, the operations it does and their peak rate,
    and the case's functions of explicit operands, for the gradient check."""
    def randn(shape):
        return torch.randn(shape, generator=gen, device=DEVICE, dtype=torch.bfloat16)

    shape = spec["shape"]
    if kind == "resblock":
        n, c, h, w = shape
        groups = spec.get("groups", 32)

        def vec(scale, shift=0.0):
            return (shift + scale * torch.randn(c, generator=gen, device=DEVICE)).bfloat16()

        def weight():
            return randn((c, c, 3, 3)) * (9 * c) ** -0.5

        ops = [1.5 * randn(shape) + 0.3, vec(0.2, 1.0), vec(0.1), weight(), vec(0.1),
               randn((n, c)), vec(0.2, 1.0), vec(0.1), weight(), vec(0.1)]
        fn = lambda *t: resblock.fused_resblock2d(*t, groups, 1e-5)  # noqa: E731
        fn_plain = lambda *t: resblock.fused_resblock2d_plain(*t, groups, 1e-5)  # noqa: E731

        def fn_lib(x, g1, b1, w1, wb1, temb, g2, b2, w2, wb2):  # the unfused arithmetic, bf16
            y = F.silu(F.group_norm(x, groups, g1, b1, 1e-5))
            y = F.conv2d(y, w1, wb1, padding=1) + temb[:, :, None, None]
            y = F.silu(F.group_norm(y, groups, g2, b2, 1e-5))
            return F.conv2d(y, w2, wb2, padding=1) + x

        closures = [lambda f=f: f(*ops) for f in (fn, fn_plain, fn_lib)]
        nbytes = 2 * (2 * n * c * h * w + 2 * 9 * c * c + 6 * c + n * c)
        return (*closures, nbytes, 2 * 2 * n * h * w * 9 * c * c, PEAK_BF16, (fn, fn_plain, ops))
    if kind == "geglu_ff":
        m, c = shape
        inner, ln = 4 * c, spec.get("ln", False)
        ops = [randn((m, c)), randn((2 * inner, c)) * c**-0.5, 0.1 * randn((2 * inner,)),
               randn((c, inner)) * inner**-0.5, 0.1 * randn((c,))]
        nbytes = 2 * (2 * m * c + 3 * c * inner + 2 * inner + c)
        if ln:
            gamma = (1.0 + 0.2 * torch.randn(c, generator=gen, device=DEVICE)).bfloat16()
            ops = [1.5 * ops[0] + 0.3, gamma, 0.2 * randn((c,))] + ops[1:]
            nbytes += 2 * 2 * c
            fn, fn_plain, fn_back = (geglu_ff.geglu_ff_ln, geglu_ff.geglu_ff_ln_plain,
                                     geglu_ff.geglu_ff_ln_unfused)

            def fn_lib(x, g, b, *rest):  # the unfused arithmetic behind torch's LayerNorm
                return geglu_ff.geglu_ff_unfused(F.layer_norm(x, (c,), g, b, 1e-5), *rest)
        else:
            fn, fn_plain = geglu_ff.geglu_ff, geglu_ff.geglu_ff_plain
            # two library products with the tanh gelu and the mul between
            fn_lib = fn_back = geglu_ff.geglu_ff_unfused
        closures = [lambda f=f: f(*ops) for f in (fn, fn_plain, fn_lib)]
        # the gradient recomputes through the unfused arithmetic
        return (*closures, nbytes, 6 * m * c * inner, PEAK_BF16, (fn, fn_back, ops))
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
            fns = (lambda *t: mha.small_mha_attention_fm(*t, heads, scale, f),
                   lambda *t: mha.small_mha_attention_fm_plain(*t, heads, scale, f))
        else:
            flops = 4 * b * sq * sk * heads * d
            if kind == "flash":
                kern = lambda: attention.flash_attention(q, k, v, scale)  # noqa: E731
                plain = lambda: attention.flash_attention_plain(q, k, v, scale)  # noqa: E731
                fns = (lambda *t: attention.flash_attention(*t, scale),
                       lambda *t: attention.flash_attention_plain(*t, scale))
            else:
                fn, fn_plain = {
                    "mha": (mha.mha_attention, mha.mha_attention_plain),
                    "small_mha": (mha.small_mha_attention, mha.small_mha_attention_plain),
                }[kind]
                kern = lambda: fn(q, k, v, heads, scale)  # noqa: E731
                plain = lambda: fn_plain(q, k, v, heads, scale)  # noqa: E731
                fns = (lambda *t: fn(*t, heads, scale), lambda *t: fn_plain(*t, heads, scale))

            def view(x):  # -> (B, H, S, D), a view
                return x.view(b, x.shape[1], heads, d).transpose(1, 2)

            lib = lambda: F.scaled_dot_product_attention(view(q), view(k), view(v), scale=scale)  # noqa: E731
        return kern, plain, lib, nbytes, flops, PEAK_BF16, (*fns, [q, k, v])

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
        fns = (lambda *t: group_norm.group_norm(*t, groups, 1e-5, act),
               lambda *t: group_norm.group_norm_plain(*t, groups, 1e-5, act))
    else:
        kern = lambda: layer_norm.layer_norm(x, weight, bias, 1e-5)  # noqa: E731
        plain = lambda: layer_norm.layer_norm_plain(x, weight, bias, 1e-5)  # noqa: E731
        lib = lambda: F.layer_norm(x, (c,), weight, bias, 1e-5)  # noqa: E731
        flops = 8 * x.numel()
        fns = (lambda *t: layer_norm.layer_norm(*t, 1e-5),
               lambda *t: layer_norm.layer_norm_plain(*t, 1e-5))
    return kern, plain, lib, nbytes, flops, PEAK_F32, (*fns, [x, weight, bias])


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


@contextlib.contextmanager
def forced_k4_path(path: str):
    """Inside this block K4 takes ``path`` wherever that path can take the
    shape (``group_norm.plan_for``), and its own plan elsewhere."""
    keep = group_norm._plan
    group_norm._plan = lambda shape, groups: group_norm.plan_for(path, shape, groups) or keep(
        shape, groups)
    try:
        yield
    finally:
        group_norm._plan = keep


def describe_plan(kind: str, spec: dict) -> str:
    """K4's or K5's plan at a case's shape, as the wrapper takes it."""
    shape = spec["shape"]
    if kind == "layer_norm":
        rows = int(np.prod(shape[:-1]))
        p = layer_norm._plan(rows, shape[-1])
        return (f"plan: {p.lanes} lanes x {p.vecs} vectors a row, {p.rows_per_warp} rows a warp, "
                f"{p.blocks} blocks of {layer_norm.WARPS} warps")
    p = group_norm._plan(tuple(shape), spec.get("groups", 32))
    return plan_text(p)


PLAN_N = {"short": "runs an item", "cluster": "CTAs a cluster", "two_pass": "slices a run"}


def plan_text(p) -> str:
    text = (f"plan: path {p.path}, n {p.n} ({PLAN_N[p.path]}), stages {p.stages}, {p.blocks} blocks, {p.smem} bytes of shared memory a block, "
            f"{p.ctas_per_sm} CTAs an SM, {p.waves:.2f} waves on {SMS} SMs")
    if p.path == "cluster":
        text += f", {group_norm.clusters_at_once(p)} clusters at once"
    return text


def phase_kernels() -> dict:
    """Each kernel against its plain version on the same inputs; the timed
    cases also beside the library call and the card's bound."""
    keys = ("errs", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "device_ms",
            "library_device_ms")
    results = {k: {key: [] for key in keys} for k in KERNELS}
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    for kind, spec, timed in KERNEL_CASES:
        kern, plain, lib, nbytes, flops, rate, _ = make_case(kind, spec, gen)
        before = _launch.LAUNCHES[kind]
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        if _launch.LAUNCHES[kind] != before + 1:
            fail(f"{kind} at {spec} did not launch its kernel")
        err, within = compare(out, ref)
        line = (f"[kernels] {kind} {spec} max_abs_err={err:.3e} "
                f"tol={KERNEL_TOL}*(1+|plain|) within={within}")
        if kind in ("mha", "flash"):
            shape = spec["shape"]
            sq, d = shape[1], (shape[3] if kind == "flash" else shape[2] // spec["heads"])
            same = torch.equal(out, kern())
            plan = mha.tile_plan(sq, spec.get("sk", sq), d, kind == "flash")
            line += f" plan(q rows, keys, stages)={plan} equal_to_the_bit_twice={same}"
            if not same:
                fail(f"{kind} at {spec}: two runs on the same inputs differ")
        if kind == "geglu_ff":
            m, c = spec["shape"]
            plan = geglu_ff._plan(m, c, 4 * c, c, torch.bfloat16)
            same = torch.equal(out, kern())
            line += (f" plan: {plan.rows} rows a block, steps of {plan.step} inner columns "
                     f"(first products of {plan.sub}), {plan.w1_stages} W1 / {plan.w2_stages} W2 "
                     f"stages, ping-pong {plan.ping_pong}, "
                     f"{plan.smem} bytes of shared memory, {plan.blocks} blocks = "
                     f"{plan.blocks / SMS:.2f} waves on {SMS} SMs; equal_to_the_bit_twice={same}")
            if not same:
                fail(f"{kind} at {spec}: two runs on the same inputs differ")
        if kind in ("group_norm", "layer_norm"):
            same = torch.equal(out, kern())
            line += f" {describe_plan(kind, spec)}; equal_to_the_bit_twice={same}"
            if not same:
                fail(f"{kind} at {spec}: two runs on the same inputs differ")
        if kind == "resblock":
            plan = resblock._plan(*spec["shape"], spec.get("groups", 32), torch.bfloat16)
            same = torch.equal(out, kern())
            line += (f" plan: M tile of 128 pixels = {plan.rows} image rows, up to {plan.max_seg} "
                     f"samples a tile, padding {100 * plan.padding:.1f} %, {160 * plan.halves} "
                     f"output channels a block, {plan.blocks} blocks = {plan.blocks / SMS:.2f} "
                     f"waves on {SMS} SMs, {plan.stages} weight stages; "
                     f"equal_to_the_bit_twice={same}")
            if not same:
                fail(f"{kind} at {spec}: two runs on the same inputs differ")
        res = results[kind]
        if timed:
            t_bytes, t_ops = 1e3 * nbytes / PEAK_BYTES, 1e3 * flops / rate
            # K1's, K6's and K7's plain versions take milliseconds a call: 3 timings
            # of 2 calls keep the script inside its time; the others as the kernels
            plain_ms = (cuda_time_ms(plain, reps=3, warmup=1, inner=2) if kind in SLOW_PLAIN
                        else cuda_time_ms(plain, inner=8))
            times = dict(ms=cuda_time_ms(kern, inner=8), plain_ms=plain_ms,
                         library_ms=cuda_time_ms(lib, inner=8), bound_ms=max(t_bytes, t_ops))
            for key, val in times.items():
                res[key].append(val)
            res["bound_by"].append("bytes" if t_bytes >= t_ops else "operations")
            line += (f" kernel_ms={times['ms']:.4f} plain_ms={times['plain_ms']:.4f} "
                     f"library_ms={times['library_ms']:.4f} bound_ms={times['bound_ms']:.4f} "
                     f"(bytes {t_bytes:.4f}, operations {t_ops:.4f})")
            if kind in DEVICE_TIMED:
                dev, host, dev_note = device_within_wall(kern, times["ms"])
                lib_dev, lib_host, lib_note = device_within_wall(lib, times["library_ms"])
                res["device_ms"].append(dev)
                res["library_device_ms"].append(lib_dev)
                line += (f" kernel_device_ms={dev:.4f}{dev_note} library_device_ms="
                         f"{lib_dev:.4f}{lib_note} host_us_per_call={host:.1f} "
                         f"library_host_us_per_call={lib_host:.1f} "
                         f"share_of_bound_on_device={100 * times['bound_ms'] / dev:.1f}%")
            if kind in ("geglu_ff", "resblock"):
                line += f" share_of_bf16_peak={100 * t_ops / times['ms']:.1f}%"
        print(line, flush=True)
        res["errs"].append(err)
        if not (bool(torch.isfinite(out).all()) and within):
            fail(f"{kind} at {spec} disagrees with its plain version: {err}")
        del out, ref, kern, plain, lib
    torch.cuda.empty_cache()
    k4_forced_paths(gen)
    k4_silu_ulps(gen)
    # A width the gate refuses takes the unfused path in the model; forced, it raises.
    c, inner = 1280, 5120
    if geglu_ff._plan(4000, c, inner, c, torch.bfloat16) is not None:
        fail("K6's gate admits C = 1280")
    zeros = lambda *shape: torch.zeros(shape, device=DEVICE, dtype=torch.bfloat16)  # noqa: E731
    try:
        geglu_ff.geglu_ff(zeros(64, c), zeros(2 * inner, c), zeros(2 * inner), zeros(c, inner),
                          zeros(c))
    except ValueError as exc:
        print(f"[kernels] geglu_ff at C = 1280, which its gate refuses, raises when forced: {exc}")
    else:
        fail("K6 did not raise on a shape its gate refuses")
    weight_cache_case(gen)
    # The same for K7: a skip-connected up-block width, and a W that does not divide a tile.
    for shape in ((2, 960, 20, 32), (2, 320, 8, 24)):
        if resblock._plan(*shape, 32, torch.bfloat16) is not None:
            fail(f"K7's gate admits {shape}")
        n, c = shape[:2]
        try:
            resblock.fused_resblock2d(
                zeros(*shape), *[zeros(c)] * 2, zeros(c, c, 3, 3), zeros(c), zeros(n, c),
                *[zeros(c)] * 2, zeros(c, c, 3, 3), zeros(c))
        except ValueError as exc:
            print(f"[kernels] resblock at {shape}, which its gate refuses, raises when forced: "
                  f"{exc}")
        else:
            fail("K7 did not raise on a shape its gate refuses")
    return results


def device_within_wall(fn, wall_ms: float) -> tuple:
    """``timing.device_ms`` of ``fn`` (ms, host µs) and a note. The wall
    window of back-to-back calls holds their device work, so a device reading
    more than 2 % above ``wall_ms`` is wrong: it is read again, and where it
    stays above, the wall reading stands for it and the note says so."""
    dev, host = device_ms(fn)
    if dev > 1.02 * wall_ms:
        dev, host = device_ms(fn)
    if dev > 1.02 * wall_ms:
        return wall_ms, host, f" (device read {dev:.4f} twice, above the wall: the wall stands)"
    return dev, host, ""


# K4's paths, each forced in turn at one shape of short runs and one of long runs
FORCED_K4 = [dict(shape=(50, 320, 40, 64), act="silu"), dict(shape=(2, 320, 25, 40, 64), act="silu")]


def k4_forced_paths(gen) -> None:
    """Every path of K4's plan forced at a short-run and a long-run shape,
    where it can take it: one launch, against the plain version, equal to
    the bit twice, and its device time."""
    for spec in FORCED_K4:
        *_, (_, fn_plain, ops) = make_case("group_norm", spec, gen)
        shape, groups = spec["shape"], spec.get("groups", 32)
        ref = fn_plain(*ops)
        for path in group_norm.PATHS:
            plan = group_norm.plan_for(path, shape, groups)
            if plan is None:
                print(f"[kernels] group_norm {spec} forced to the {path} path: it cannot take "
                      f"runs of {group_norm._dims(shape, groups)[1]} elements", flush=True)
                continue
            kern = lambda plan=plan: group_norm._group_norm_cuda(  # noqa: E731
                *ops, groups, 1e-5, spec["act"], plan)
            before = _launch.LAUNCHES["group_norm"]
            out = kern()
            torch.cuda.synchronize()
            if _launch.LAUNCHES["group_norm"] != before + 1:
                fail(f"group_norm forced to {path} at {spec} did not launch its kernel")
            err, within = compare(out, ref)
            same = torch.equal(out, kern())
            dev, host = device_ms(kern)
            print(f"[kernels] group_norm {spec} forced to the {path} path: max_abs_err={err:.3e} "
                  f"tol={KERNEL_TOL}*(1+|plain|) within={within} equal_to_the_bit_twice={same} "
                  f"kernel_device_ms={dev:.4f} host_us_per_call={host:.1f}; {plan_text(plan)}",
                  flush=True)
            if not (bool(torch.isfinite(out).all()) and within and same):
                fail(f"group_norm forced to {path} at {spec} disagrees with its plain version")
            del out
        del ops, ref
    torch.cuda.empty_cache()


def bf16_ulps(a, b) -> int:
    """The largest distance between two bf16 tensors in bf16 ulps."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return int((ordered(a) - ordered(b)).abs().max())


# K4's SiLU probe: gamma 0 and beta spread over [-10, 0] across 2560 channels
# make each normalised value y = beta exactly, in the kernel and in the plain
# version, so that the two differ by the SiLU and its rounding alone
SILU_PROBE, SILU_ULPS = (2, 2560, 5, 8), 1


def k4_silu_ulps(gen) -> None:
    """K4's SiLU on every path within SILU_ULPS bf16 ulps of the plain
    version's, at y in [-10, 0], where 1 + exp(-y) is large."""
    x = torch.randn(SILU_PROBE, generator=gen, device=DEVICE).bfloat16()
    w = torch.zeros(SILU_PROBE[1], device=DEVICE)
    b = torch.linspace(-10.0, 0.0, SILU_PROBE[1], device=DEVICE)
    ref = group_norm.group_norm_plain(x, w, b, 32, 1e-5, "silu")
    for path in group_norm.PATHS:
        plan = group_norm.plan_for(path, SILU_PROBE, 32)
        out = group_norm._group_norm_cuda(x, w, b, 32, 1e-5, "silu", plan)
        ulps = bf16_ulps(out, ref)
        print(f"[kernels] group_norm SiLU at y in [-10, 0] over {SILU_PROBE[1]} channels "
              f"{SILU_PROBE}, {path} path: {ulps} bf16 ulps from the plain version at most "
              f"(limit {SILU_ULPS})", flush=True)
        if ulps > SILU_ULPS:
            fail(f"K4's SiLU on the {path} path is {ulps} bf16 ulps from the plain version")


def weight_cache_case(gen) -> None:
    """K7 re-lays a weight once while it is unchanged: a cold call re-lays
    both, a warm one neither; an update in place under no_grad makes one fresh
    copy, and the next output is the plain version's with the new weight."""
    kern, plain, *_, (_, _, ops) = make_case("resblock", dict(shape=(50, 1280, 5, 8)), gen)
    relaid = lambda: resblock.relaid_weights.relayouts  # noqa: E731

    def timed_call():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = kern()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    before = relaid()
    cold, cold_ms = timed_call()
    warm, warm_ms = timed_call()
    cold_copies, warm_copies = relaid() - before, relaid() - before - 2
    with torch.no_grad():
        ops[8].add_(0.5 * ops[8].flip(0))
    new, new_ms = timed_call()
    err, within = compare(new, plain())
    print(f"[kernels] resblock weight cache at (50, 1280, 5, 8): cold call {cold_ms:.3f} ms, "
          f"{cold_copies} weights re-laid; warm call {warm_ms:.3f} ms, {warm_copies} re-laid; "
          f"after w2.add_ under no_grad {new_ms:.3f} ms, {relaid() - before - 2} re-laid, "
          f"against the plain version with the new weight max_abs_err={err:.3e} "
          f"within={within}; warm equals cold to the bit: {torch.equal(cold, warm)}", flush=True)
    if (cold_copies, warm_copies, relaid() - before) != (2, 0, 3) or not within:
        fail("K7's weight cache did not re-lay exactly when a weight was new or changed")
    if not torch.equal(cold, warm) or torch.equal(new, cold):
        fail("K7's output did not follow its weights")


def phase_grads() -> None:
    """Each kernel under autograd at a shape of the training micro-step: the
    wrapper's output against the plain version's, and the gradient of
    sum(out * r) through the wrapper (kernel forward, recompute backward)
    against the same through the function it recomputes with alone: the
    plain version, for K6 the unfused arithmetic (tanh gelu, bf16 products),
    as the JAX package's custom VJP has it."""
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    for kind, spec in GRAD_CASES:
        _, plain, *_, (fn, fn_back, ops) = make_case(kind, spec, gen)
        back_name = "the unfused arithmetic" if kind == "geglu_ff" else "the plain version"

        def grads_of(f):
            ins = [t.detach().clone().requires_grad_(True) for t in ops]
            out = f(*ins)
            if not out.requires_grad:
                fail(f"{kind}: the output carries no gradient")
            return out, torch.autograd.grad((out.float() * r).sum(), ins)

        r = torch.randn(spec["shape"], generator=gen, device=DEVICE)
        before = _launch.LAUNCHES[kind]
        out, grads = grads_of(fn)
        if _launch.LAUNCHES[kind] != before + 1:
            fail(f"{kind} at {spec} did not launch its kernel under autograd")
        with torch.no_grad():
            err, within = compare(out.detach(), plain())
        _, ref = grads_of(fn_back)
        torch.cuda.synchronize()
        rels = []
        for g, g_ref in zip(grads, ref):
            rels.append(((g.float() - g_ref.float()).norm() / g_ref.float().norm()).item())
            if g.shape != g_ref.shape or not bool(torch.isfinite(g).all()):
                fail(f"{kind}: gradient of shape {tuple(g.shape)} is not finite")
        print(f"[grads] {kind} {spec}: forward under autograd vs the plain version "
              f"max_abs_err={err:.3e} tol={KERNEL_TOL}*(1+|plain|) within={within}; rel_l2 of "
              f"the gradients of {len(ops)} operands against {back_name}'s "
              f"{', '.join(f'{x:.2e}' for x in rels)} (tol {GRAD_TOL})", flush=True)
        if not (bool(torch.isfinite(out).all()) and within):
            fail(f"{kind} at {spec} under autograd disagrees with its plain version: {err}")
        if max(rels) > GRAD_TOL:
            fail(f"{kind}: the wrapper's gradient differs from {back_name}'s: {rels}")
        del out, grads, ref, ops, plain, fn, fn_back
    torch.cuda.empty_cache()


def build_models():
    """Full-width models on the card (``tools.bench.build_models``, seeded
    random bf16 weights): the Box2Video UNet and ControlNet, the stage-1 UNet
    (frames-major), and the VAE and CLIP that both stages share."""
    t0 = time.perf_counter()
    models = bench.build_models(DEVICE)
    n_params = sum(p.numel() for m in models.values() for p in m.parameters())
    torch.cuda.synchronize()
    print(f"[models] {n_params / 1e9:.3f} B params in bf16 on the card, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    return models


def count_modules(net, cls) -> int:
    return sum(isinstance(m, cls) for m in net.modules())


def count_routed_ff(net) -> int:
    """Feed-forwards of ``net`` whose width K6's gate admits."""
    return sum(isinstance(m, layers.FeedForward)
               and geglu_ff._plan(1, m.net[2].in_features // 4, m.net[2].in_features,
                                  m.net[2].out_features, torch.bfloat16) is not None
               for m in net.modules())


def routed_resblocks(block, n: int, h: int, w: int) -> int:
    """Spatial ResBlocks of ``block`` that go to K7 when it is on, at a batch of
    n frames of h x w: same-channel, with a time embedding, and admitted by the gate."""
    return sum(isinstance(m, ResnetBlock2D) and m.conv_shortcut is None
               and m.time_emb_proj is not None
               and resblock._plan(n, m.conv1.in_channels, h, w, m.norm1.num_groups,
                                  torch.bfloat16) is not None
               for m in block.modules())


def blocks_by_level(net):
    """(block, level) over a UNet's or a ControlNet's down, mid and up blocks;
    level i works on latents of 1 / 2**i the size."""
    top = len(net.down_blocks) - 1
    return ([(b, i) for i, b in enumerate(net.down_blocks)] + [(net.mid_block, top)]
            + [(b, top - i) for i, b in enumerate(getattr(net, "up_blocks", ()))])


def routed_resblocks_of(net, n: int, h: int, w: int) -> int:
    return sum(routed_resblocks(b, n, h >> lvl, w >> lvl) for b, lvl in blocks_by_level(net))


def decode_calls(frames: int, chunk: int, max_frames) -> int:
    """Calls of the VAE decoder that decode_latents makes for one batch."""
    n_full, rem = divmod(frames, chunk)
    per_call = max(1, min(n_full, max_frames // chunk)) if max_frames else n_full
    return (-(-n_full // per_call) if n_full else 0) + (1 if rem else 0)


def expected_launches(models, forwards: dict, temporal: dict, k6: bool = True) -> dict:
    """Launches a path should make. ``forwards``: calls of each net (for the
    VAE its encoder and decoder apart); ``temporal``: for each UNet or
    ControlNet the temporal kernel it takes and whether its batch puts the
    mid block over the kernel's gate of 256 pixels; ``k6``: K6's switch."""
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
            exp["geglu_ff"] += calls * count_routed_ff(nets[key]) * k6
    return exp


def make_step(models):
    """A full-width ControlNet+UNet denoise step on seeded inputs (CFG batch
    2 x 25 frames), as a closure, and its latent height and width."""
    h, w = H // VAE_CONFIG.spatial_scale, W // VAE_CONFIG.spatial_scale
    return profile_denoise.make_step(models["ctrl"], models["unet"], DEVICE, FRAMES, h, w), h, w


# [step]'s variants that force K4's paths (each where it can take the shape)
K4_FORCED = {"K4 short": "short", "K4 cluster": "cluster", "K4 two-pass": "two_pass"}


@torch.no_grad()
def phase_step(models) -> None:
    """One full-width ControlNet+UNet step: all default kernels' worth (the
    frames-major layout puts K3 in K2's place), each newer kernel switched
    off in turn, K7 (off by default) switched on, and all plain. In turns,
    forwards and backwards."""
    step, h, w = make_step(models)
    nets = (models["ctrl"], models["unet"])

    def run(variant: str, fn):
        """``fn`` under one variant's switches, which are put back after."""
        if variant.startswith("K4 ") and variant != "K4 off":
            with forced_k4_path(K4_FORCED[variant]):
                return run("all kernels", fn)
        bench.set_temporal_layout(nets, "seq" if variant == "K3 off" else "frames_major")
        group_norm.set_fused_group_norm(variant != "K4 off")
        layer_norm.set_fused_layer_norm(variant != "K5 off")
        # "xla": every attention site to the library's attention (K1-K3 and K8 off)
        attention.set_attention_impl("xla" if variant == "xla" else "auto")
        geglu_ff.set_fused_geglu_ff(variant != "K6 off")
        resblock.set_fused_resblock(variant == "K7 on")
        try:
            if variant == "all plain":
                with _launch.plain_kernels():
                    return fn()
            return fn()
        finally:
            bench.set_temporal_layout(nets, "seq")
            group_norm.set_fused_group_norm(True)
            layer_norm.set_fused_layer_norm(True)
            attention.set_attention_impl("auto")
            geglu_ff.set_fused_geglu_ff(True)
            resblock.set_fused_resblock(False)

    variants = ("all kernels", "K3 off", "K4 off", *K4_FORCED, "K5 off", "xla", "K6 off",
                "K7 on", "all plain")
    _launch.reset_launch_counts()
    preds = {v: run(v, step) for v in ("all kernels", "all plain")}
    torch.cuda.synchronize()
    counts = dict(_launch.LAUNCHES)
    expect = expected_launches(models, {"ctrl": 1, "unet": 1},
                               {"ctrl": ("small_mha_fm", False), "unet": ("small_mha_fm", False)})
    if counts != expect:
        fail(f"one step launched {counts}, expected {expect}")
    # K6 on (the default): one launch for every feed-forward its gate admits; off: none
    routed_ff = expect["geglu_ff"]
    if not routed_ff:
        fail("no feed-forward of the step is routed to geglu_ff")
    _launch.reset_launch_counts()
    preds["K6 off"] = run("K6 off", step)
    torch.cuda.synchronize()
    counts_k6 = dict(_launch.LAUNCHES)
    if counts_k6 != dict(expect, geglu_ff=0):
        fail(f"one step with K6 off launched {counts_k6}, expected {dict(expect, geglu_ff=0)}")
    rel_k6 = ((preds["K6 off"] - preds["all plain"]).norm() / preds["all plain"].norm()).item()
    # K7 on: one launch for every ResBlock its gate admits, whose two norms K4 no longer sees
    _launch.reset_launch_counts()
    preds["K7 on"] = run("K7 on", step)
    torch.cuda.synchronize()
    counts_k7 = dict(_launch.LAUNCHES)
    routed = {k: routed_resblocks_of(models[k], 2 * FRAMES, h, w) for k in ("ctrl", "unet")}
    expect_k7 = dict(expect, resblock=sum(routed.values()),
                     group_norm=expect["group_norm"] - 2 * sum(routed.values()))
    if counts_k7 != expect_k7 or not expect_k7["resblock"]:
        fail(f"one step with K7 on launched {counts_k7}, expected {expect_k7}")
    rel_k7 = ((preds["K7 on"] - preds["all plain"]).norm() / preds["all plain"].norm()).item()
    # --attention_impl xla: no attention kernel, K1-K3 and K8 alike, as in the JAX package
    _launch.reset_launch_counts()
    preds["xla"] = run("xla", step)
    torch.cuda.synchronize()
    counts_xla = dict(_launch.LAUNCHES)
    attn = ("mha", "small_mha", "small_mha_fm", "flash")
    expect_xla = dict(expect, **dict.fromkeys(attn, 0))
    if counts_xla != expect_xla:
        fail(f"one step under attention_impl xla launched {counts_xla}, expected {expect_xla}")
    rel_xla = ((preds["xla"] - preds["all plain"]).norm() / preds["all plain"].norm()).item()

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
    print(f"[step] K6 off vs all plain: rel_l2={rel_k6:.3e}; {routed_ff} launches of geglu_ff a "
          f"step with K6 on (the feed-forwards at C = 320 and 640; C = 1280 by the gate to the "
          f"unfused path)", flush=True)
    print(f"[step] K7 on vs all plain: rel_l2={rel_k7:.3e}; {counts_k7['resblock']} launches of "
          f"resblock a step ({routed['unet']} same-channel spatial ResBlocks of the UNet, "
          f"{routed['ctrl']} of the ControlNet; every up-block ResBlock has a 1x1 shortcut and "
          f"takes the unfused path), {counts_k7['group_norm']} of group_norm", flush=True)
    print(f"[step] xla vs all plain: rel_l2={rel_xla:.3e}; launches of K1, K2, K3, K8 "
          f"{[counts_xla[k] for k in attn]} (the library's attention at every site)", flush=True)
    if not (torch.isfinite(pred).all() and max(rel, rel_k6, rel_k7, rel_xla) <= STEP_TOL):
        fail(f"kernel step differs from the plain step: rel_l2 {rel}, with K6 {rel_k6}, with K7 "
             f"{rel_k7}, under xla {rel_xla}")


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
        bench.init_random_(m, seed)
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
    # K6's gate admits no width of the small config; K7 is off by default
    if any(v == 0 for k, v in counts.items() if k not in ("geglu_ff", "resblock")):
        fail(f"small overall did not reach every kernel: {counts}")
    if not (torch.isfinite(lat).all() and rel <= SMALL_LATENT_TOL):
        fail("small stage-1 latents on the card differ from their f32 reference")
    same = res["best_guidance"] == res_ref["best_guidance"]
    if not same and abs(res["miou"] - res_ref["miou"]) > SMALL_IOU_TOL:
        fail("small overall chose another candidate than its f32 reference, and no near-tie")
    if same and not (mean_err <= SMALL_TOL[0] and max_err <= SMALL_TOL[1]):
        fail("small overall video on the card differs from its f32 reference")


def synthetic_request(seed: int):
    """A first frame and 25 bbox frames in [-1, 1] (``tools.bench.synthetic_request``)."""
    return bench.synthetic_request(seed, FRAMES, H, W)


def check_clip(name: str, out, shape) -> None:
    out = torch.as_tensor(out)
    finite = bool(torch.isfinite(out).all())
    lo, hi = out.min().item(), out.max().item()
    if tuple(out.shape) != shape or not finite or lo < 0.0 or hi > 1.0:
        fail(f"{name}: shape {tuple(out.shape)}, finite {finite}, range [{lo}, {hi}]")


# K4's and K5's launches by input shape on each path, a request or a micro-step
LAUNCHES_BY_SHAPE: dict = {}
NORM_KINDS = ((layers.GroupNorm, "group_norm"), (layers.LayerNorm, "layer_norm"))


@contextlib.contextmanager
def launches_by_shape(path: str, nets):
    """Inside this block, forward hooks on every GroupNorm and LayerNorm of
    ``nets`` add the launches of K4 and K5 in each call to its input shape
    ((B, C, *spatial); (rows, C) for K5) into ``LAUNCHES_BY_SHAPE[path]``.
    The hooks cost the host a Python call and a dict copy a norm: a run
    under them is an extra one, never a timed one."""
    counts, started, handles = {}, [], []

    def pre(module, args):
        started.append(dict(_launch.LAUNCHES))

    def post(module, args, out):
        kind = next(k for cls, k in NORM_KINDS if isinstance(module, cls))
        n = _launch.LAUNCHES[kind] - started.pop()[kind]
        if n:
            x = args[0]
            shape = tuple(x.shape) if kind == "group_norm" else (x.numel() // x.shape[-1],
                                                                  x.shape[-1])
            counts[(kind, shape)] = counts.get((kind, shape), 0) + n

    for net in nets:
        for m in net.modules():
            if isinstance(m, tuple(cls for cls, _ in NORM_KINDS)):
                handles += [m.register_forward_pre_hook(pre), m.register_forward_hook(post)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()
        LAUNCHES_BY_SHAPE[path] = counts


def print_launches_by_shape() -> None:
    paths = list(LAUNCHES_BY_SHAPE)
    keys = sorted({k for by in LAUNCHES_BY_SHAPE.values() for k in by})
    print(f"[shapes] launches of K4 and K5 by input shape, a request (box2video, overall), a "
          f"micro-step (train, train_svd) or a forward (legacy_unet2d); columns: "
          f"{', '.join(paths)}")
    for kind, shape in keys:
        print(f"[shapes] {kind} {shape}: " + ", ".join(
            f"{LAUNCHES_BY_SHAPE[p].get((kind, shape), 0):g}" for p in paths), flush=True)


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

    def request(seed):
        image, cond = synthetic_request(seed)
        return pipe(image, cond, generator=torch.Generator(device=DEVICE).manual_seed(seed),
                    num_frames=FRAMES, num_inference_steps=STAGE2_STEPS, min_guidance_scale=1.0,
                    max_guidance_scale=3.0, decode_chunk_size=CHUNK)

    for seed in (1, 2):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        _launch.reset_launch_counts()
        t0 = time.perf_counter()
        out = request(seed)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(_launch.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"[sampler] seed {seed}: {tuple(out.shape)} in [{out.min().item():.3f}, "
              f"{out.max().item():.3f}] std {out.std().item():.3f}, {secs:.3f} s/clip, "
              f"max_memory_allocated {peak:.2f} GiB, launches {counts}; card {card}", flush=True)
        check_clip("the Box2Video clip", out, (1, FRAMES, H, W, 3))
        check_launches("the Box2Video request", counts, expect)
    # K4's and K5's launches by input shape: a third request, untimed, under the hooks
    _launch.reset_launch_counts()
    with launches_by_shape("box2video", models.values()):
        check_clip("the Box2Video clip under the shape hooks", request(3), (1, FRAMES, H, W, 3))
    check_launches("the Box2Video request under the shape hooks", dict(_launch.LAUNCHES), expect)
    return counts


def phase_overall(models, card: str) -> dict:
    """Two two-stage requests with the JAX package's defaults (five
    candidates, 30 + 25 steps, decode chunk 8): K6 on, its default (this
    slice's main path, whose launches are returned), then K6 off, for its
    A/B."""
    bbox = VideoDiffusionPipeline(models["unet1"], models["vae"], models["clip"])
    ctrl = StableVideoControlPipeline(models["unet"], models["ctrl"], models["vae"],
                                      models["clip"])
    pipe = OverallPipeline(bbox, ctrl)
    image, cond = synthetic_request(2)
    n = len(GUIDANCE_PAIRS)

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

    def request():
        return pipe(image[0], cond[0], generator=torch.Generator(device=DEVICE).manual_seed(2),
                    num_frames=FRAMES, stage1_steps=STAGE1_STEPS, stage2_steps=STAGE2_STEPS,
                    decode_chunk_size=CHUNK, max_decode_frames=MAX_DECODE_FRAMES)

    results = {}
    for k6 in (True, False):
        geglu_ff.set_fused_geglu_ff(k6)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        _launch.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            res = request()
            torch.cuda.synchronize()
        finally:
            geglu_ff.set_fused_geglu_ff(True)
        secs = time.perf_counter() - t0
        counts = dict(_launch.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        select = secs - stage_secs["stage1"] - stage_secs["stage2"]
        tag = "K6 on (default)" if k6 else "K6 off"
        print(f"[overall] {tag}: {n} candidates x {FRAMES} frames at {W}x{H}: {secs:.3f} "
              f"s/request = stage 1 {stage_secs['stage1']:.3f} s ({STAGE1_STEPS} steps, UNet "
              f"batch {2 * n}x{FRAMES}) + select {select:.3f} s + stage 2 "
              f"{stage_secs['stage2']:.3f} s ({STAGE2_STEPS} steps); max_decode_frames "
              f"{MAX_DECODE_FRAMES}; max_memory_allocated {peak:.2f} GiB; card {card}", flush=True)
        print(f"[overall] {tag}: best_guidance {res['best_guidance']} miou {res['miou']:.4f} ap "
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
        expect = expected_launches(
            models,
            {"clip": 2, "enc": 4, "ctrl": STAGE2_STEPS, "unet": STAGE2_STEPS,
             "unet1": STAGE1_STEPS, "dec": decode_calls(FRAMES, CHUNK, MAX_DECODE_FRAMES) * 2},
            {"ctrl": ("small_mha", False), "unet": ("small_mha", False),
             "unet1": ("small_mha_fm", 2 * n * 40 >= 256)},
            k6=k6,
        )
        check_launches(f"the overall request with {tag}", counts, expect)
        results[k6] = counts
    # K4's and K5's launches by input shape: a third request (K6 on), untimed, under the hooks
    _launch.reset_launch_counts()
    with launches_by_shape("overall", models.values()):
        request()
    check_launches("the overall request under the shape hooks", dict(_launch.LAUNCHES),
                   results[True])
    return results[True]


class KeepGradients:
    """A transformation that moves nothing and keeps the last gradients, to
    read a micro-step's gradients from the step the trainer runs."""

    def init(self, params):
        return {}

    def update(self, grads, state, params):
        return {"grads": grads}


def train_expected_launches(nets, block_runs, batch: int, lat_hw, encoder_calls: int,
                            k6_ff: int = 0, k7: bool = False) -> dict:
    """Launches of one training micro-step in the "seq" layout with block
    checkpointing. ``block_runs`` lists (block, level, forwards) for the UNet's
    and the ControlNet's blocks: a checkpointed block that carries a graph runs
    its forward twice, one that carries none runs once, as do the UNet's last
    norm, the VAE encoder and CLIP. Level i has 1 / 4**i of the latent's tokens
    a frame; the spatial attention takes K1 from 1024 tokens and K8 from 128, the
    temporal one K2 from 256 pixels in the batch; a ResBlock that K7 takes
    launches no K4 for its two norms. K6 takes only the forwards of routed
    feed-forwards that want no gradient: ``k6_ff``, which the caller counts."""
    exp = dict.fromkeys(_launch.LAUNCHES, 0)
    h, w = lat_hw
    for block, level, runs in block_runs:
        s = (h * w) // 4**level
        n_tr = len(getattr(block, "attentions", ()))
        routed = routed_resblocks(block, batch * FRAMES, h >> level, w >> level) if k7 else 0
        exp["group_norm"] += runs * (count_modules(block, layers.GroupNorm) - 2 * routed)
        exp["resblock"] += runs * routed
        exp["layer_norm"] += runs * count_modules(block, layers.LayerNorm)
        exp["mha"] += runs * n_tr * (s >= 1024)
        exp["flash"] += runs * n_tr * (128 <= s < 1024)
        exp["small_mha"] += runs * n_tr * (batch * s >= 256)
    exp["geglu_ff"] = k6_ff
    exp["group_norm"] += 1  # the UNet's conv_norm_out
    exp["group_norm"] += encoder_calls * count_modules(nets["vae"].encoder, layers.GroupNorm)
    exp["layer_norm"] += count_modules(nets["clip"], layers.LayerNorm)
    return exp


def check_metrics(name: str, metrics) -> tuple:
    loss, norm = metrics["loss"].item(), metrics["grad_norm"].item()
    if not (np.isfinite(loss) and loss > 0 and np.isfinite(norm) and norm > 0):
        fail(f"{name}: loss {loss}, grad norm {norm}")
    return loss, norm


def against_plain(result: dict, ref_name: str = "all plain") -> None:
    """Adds each variant's loss and gradients relative to the all-plain run's."""
    ref = result[ref_name]
    den = sum(float(g.float().square().sum()) for g in ref["grads"].values())
    for variant, res in result.items():
        if variant == ref_name:
            continue
        num = sum(float((res["grads"][k].float() - g.float()).square().sum())
                  for k, g in ref["grads"].items())
        res["grad_rel"] = (num / den) ** 0.5
        res["loss_rel"] = abs(res["loss"] - ref["loss"]) / abs(ref["loss"])
        if res["loss_rel"] > TRAIN_LOSS_TOL or res["grad_rel"] > TRAIN_GRAD_TOL:
            fail(f"training micro-step with {variant} differs from all plain: "
                 f"{res['loss_rel']}, {res['grad_rel']}")


def make_micro_step(clips, bbox, draws, switch, on_variant: str, default: bool):
    """A runner of one training micro-step on the batch under a variant's
    switches: ``on_variant`` turns ``switch`` (a kernel's, whose default is
    ``default``) on and every other variant off, "all plain" selects every
    plain version; the switch is put back to its default after.
    ``micro_step(step_fn, state, variant) -> (state, metrics, seconds, launches)``."""

    def micro_step(step_fn, st, variant: str):
        switch(variant == on_variant)
        torch.cuda.synchronize()
        _launch.reset_launch_counts()
        t1 = time.perf_counter()
        try:
            if variant == "all plain":
                with _launch.plain_kernels():
                    st, metrics = step_fn(st, clips, bbox, draws=draws)
            else:
                st, metrics = step_fn(st, clips, bbox, draws=draws)
        finally:
            switch(default)
        torch.cuda.synchronize()
        return st, metrics, time.perf_counter() - t1, dict(_launch.LAUNCHES)

    return micro_step


def run_updates(tag: str, micro_step, step, state, tx, variant: str, expect: dict):
    """Two optimizer updates at accumulation ACCUM under ``variant``, the main
    path's run of a training phase: every micro-step's loss, launches and
    which parameters moved are checked. Returns (state, the launches summed,
    s/micro-step without the updates, s/update, peak GiB)."""
    update_secs = []
    inner_update = tx.inner.update

    def timed_update(*args):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = inner_update(*args)
        torch.cuda.synchronize()
        update_secs.append(time.perf_counter() - t1)
        return out

    tx.inner.update = timed_update
    torch.cuda.reset_peak_memory_stats()
    before = {k: p.detach().clone() for k, p in state.params.items()}
    path_counts = dict.fromkeys(_launch.LAUNCHES, 0)
    step_secs = []
    for i in range(2 * ACCUM):
        state, metrics, secs, counts = micro_step(step, state, variant)
        loss, norm = check_metrics(f"micro-step {i}", metrics)
        moved = sum(not torch.equal(p.detach(), before[k]) for k, p in state.params.items())
        updates = (i + 1) % ACCUM == 0
        print(f"[{tag}] micro-step {i}: {secs:.3f} s, loss {loss:.4f}, grad norm {norm:.4f}, "
              f"{moved} of {len(before)} parameter tensors moved, launches {counts}", flush=True)
        if counts != expect:
            fail(f"micro-step {i} launched {counts}, expected {expect}")
        if updates != (moved > 0):
            fail(f"micro-step {i}: {moved} parameter tensors moved, update due: {updates}")
        if updates:
            before = {k: p.detach().clone() for k, p in state.params.items()}
        step_secs.append(secs - (update_secs[-1] if updates else 0.0))
        for k, v in counts.items():
            path_counts[k] += v
    tx.inner.update = inner_update
    peak = torch.cuda.max_memory_allocated() / 2**30
    if state.step != 2 * ACCUM or state.opt_state["gradient_step"] != 2:
        fail(f"train state after the updates: step {state.step}, "
             f"{state.opt_state['gradient_step']}")
    return state, path_counts, step_secs, update_secs, peak


def run_variants(micro_step, probe, probe_state, variants, expects: dict,
                 rounds: int = 1) -> dict:
    """One micro-step a variant from the same parameters and draws with the
    gradients kept, then 2 * ``rounds`` more timings a variant, in turns
    backwards and forwards. The last variant is all plain, which launches nothing; each
    other one launches what ``expects`` has for it. Loss and gradients are
    held against all plain."""
    result = {}
    for variant in variants:
        st, metrics, secs, counts = micro_step(probe, probe_state, variant)
        loss, norm = check_metrics(variant, metrics)
        result[variant] = dict(loss=loss, norm=norm, secs=[secs], counts=counts,
                               grads=st.opt_state["grads"])
        st.opt_state = {}
    for order in (variants[::-1], variants) * rounds:
        for variant in order:
            st, _, secs, _ = micro_step(probe, probe_state, variant)
            st.opt_state = {}
            result[variant]["secs"].append(secs)
    for variant, expect in expects.items():
        if result[variant]["counts"] != expect:
            fail(f"{variant} launched {result[variant]['counts']}, expected {expect}")
    if any(result["all plain"]["counts"].values()):
        fail(f"all plain launched {result['all plain']['counts']}")
    against_plain(result)
    return result


def report_variants(tag: str, title: str, result: dict, updates, card: str) -> None:
    _, _, step_secs, update_secs, peak = updates
    on, off, plain = result
    n = len(result[on]["secs"])
    print(f"[{tag}] {title}: s/micro-step, median of {n} taken in turns: "
          + ", ".join(f"{v} {np.median(result[v]['secs']):.3f}" for v in result) + f" (the {n}: "
          + "; ".join(", ".join(f"{x:.3f}" for x in result[v]["secs"]) for v in result)
          + f"); the {2 * ACCUM} accumulated micro-steps with {on}, without their updates, "
          f"{', '.join(f'{x:.3f}' for x in step_secs)} s; optimizer update "
          f"{', '.join(f'{x:.3f}' for x in update_secs)} s; max_memory_allocated {peak:.2f} GiB; "
          f"card {card}", flush=True)
    print(f"[{tag}] against all plain (loss {result[plain]['loss']:.5f}, grad norm "
          f"{result[plain]['norm']:.4f}): " + "; ".join(
              f"{v} loss_rel={result[v]['loss_rel']:.3e} grad_rel_l2={result[v]['grad_rel']:.3e}"
              for v in (on, off)) + f" (tol {TRAIN_LOSS_TOL}, {TRAIN_GRAD_TOL})", flush=True)


def phase_train(models, card: str) -> dict:
    """The ControlNet training step at full width (this slice's main path):
    1 x 25 frames at 512x320, device-random clips, "seq" layout, block
    checkpointing, encode chunk 5, AdamW (bf16 first moment, lr 1e-5) under
    accumulation 2."""
    t0 = time.perf_counter()
    with torch.device(DEVICE):
        unet = UNetSpatioTemporalConditionModel(UNET_CONFIG, gradient_checkpointing=True)
        ctrl = ControlNetSpatioTemporal(UNET_CONFIG, gradient_checkpointing=True)
    # the serving models' seeded weights; the zero convs are random too, so
    # that every ControlNet parameter gets a gradient through every kernel
    unet.to(torch.bfloat16).load_state_dict(models["unet"].state_dict())
    ctrl.to(torch.bfloat16).load_state_dict(models["ctrl"].state_dict())
    ctrl.train().requires_grad_(True)
    nets = dict(unet=unet, ctrl=ctrl, vae=models["vae"], clip=models["clip"])
    tx = MultiSteps(make_optimizer(learning_rate=1e-5, nan_guard_steps=0, mu_dtype="bfloat16"),
                    ACCUM)
    step = make_controlnet_train_step(unet, ctrl, nets["vae"], nets["clip"], tx,
                                      conditioning_dropout_prob=0.1, encode_chunk=ENCODE_CHUNK)
    state = init_train_state(ctrl, tx)
    probe_tx = KeepGradients()
    probe = make_controlnet_train_step(unet, ctrl, nets["vae"], nets["clip"], probe_tx,
                                       conditioning_dropout_prob=0.1, encode_chunk=ENCODE_CHUNK)
    n_train = sum(p.numel() for p in state.params.values())
    print(f"[train] models built in {time.perf_counter() - t0:.1f} s; {n_train / 1e9:.3f} B "
          f"trainable parameters in {len(state.params)} tensors", flush=True)

    gen = torch.Generator(device=DEVICE).manual_seed(7)
    scale = VAE_CONFIG.spatial_scale
    lat = (H // scale, W // scale, 4)
    clips, bbox = (2 * torch.rand((1, FRAMES, H, W, 3), generator=gen, device=DEVICE) - 1
                   for _ in range(2))
    normal = lambda *shape: torch.randn(shape, generator=gen, device=DEVICE)  # noqa: E731
    draws = {
        "latent_noise": normal(FRAMES, *lat), "init_noise": normal(1, *lat),
        "cond_noise": normal(FRAMES, *lat), "noise": normal(1, FRAMES, *lat),
        "sigma_idx": torch.tensor([500], device=DEVICE),
        "dropout_u": torch.tensor([0.9], device=DEVICE),  # keeps both conditionings
    }
    encoder_calls = 2 * -(-FRAMES // ENCODE_CHUNK) + 1
    # the ControlNet's blocks and the UNet's up blocks carry a graph; the frozen
    # UNet's down and mid blocks carry none: the residuals join after them
    up = {id(b) for b in unet.up_blocks}
    block_runs = ([(b, lvl, 2) for b, lvl in blocks_by_level(ctrl)]
                  + [(b, lvl, 2 if id(b) in up else 1) for b, lvl in blocks_by_level(unet)])

    micro_step = make_micro_step(clips, bbox, draws, geglu_ff.set_fused_geglu_ff, "K6 on", True)
    frozen = {k: {n: p.detach().clone() for n, p in nets[k].state_dict().items()}
              for k in ("unet", "vae", "clip")}
    probe_state = init_train_state(ctrl, probe_tx)
    with launches_by_shape("train", nets.values()):  # K4's and K5's launches by input shape
        _, metrics, secs, _ = micro_step(probe, probe_state, "K6 on")
    print(f"[train] warm-up micro-step (under the shape hooks) {secs:.3f} s, loss "
          f"{check_metrics('warm-up', metrics)[0]:.4f}", flush=True)

    # Two optimizer updates at accumulation 2, K6 on: the main path's run.
    # K6 takes the feed-forwards that want no gradient: those of the frozen
    # UNet's down blocks, which carry no graph and run once
    k6_ff = sum(count_routed_ff(b) for b, _, runs in block_runs if runs == 1)
    expect = train_expected_launches(nets, block_runs, 1, lat[:2], encoder_calls, k6_ff=k6_ff)
    updates = run_updates("train", micro_step, step, state, tx, "K6 on", expect)
    off_expect = train_expected_launches(nets, block_runs, 1, lat[:2], encoder_calls)
    # K6's routing A/B: seven timings a variant
    result = run_variants(micro_step, probe, probe_state, ("K6 on", "K6 off", "all plain"),
                          {"K6 on": expect, "K6 off": off_expect}, rounds=3)
    ref = result["all plain"]
    zero_convs = [k for k in ref["grads"] if k.startswith(("controlnet_down_blocks",
                                                           "controlnet_mid_block"))]
    dead = [k for k in zero_convs if not float(result["K6 on"]["grads"][k].abs().max()) > 0]
    if len(zero_convs) != 2 * (len(ctrl.controlnet_down_blocks) + 1) or dead:
        fail(f"zero convs without a gradient: {dead} of {len(zero_convs)}")
    for k in ("unet", "vae", "clip"):
        changed = [n for n, p in nets[k].state_dict().items() if not torch.equal(p, frozen[k][n])]
        if changed or any(p.requires_grad for p in nets[k].parameters()):
            fail(f"the frozen {k} changed: {changed[:3]}")

    report_variants("train", f"ControlNet micro-step, 1x{FRAMES} frames at {W}x{H}, seq layout, "
                    f"block checkpointing, encode chunk {ENCODE_CHUNK}", result, updates, card)
    print(f"[train] {len(zero_convs)} zero-conv tensors all with a gradient; UNet, VAE and CLIP "
          f"bit-identical", flush=True)
    path_counts = updates[1]
    if not path_counts["geglu_ff"]:
        fail("the training path did not launch K6")
    return path_counts


DIST_STEPS = 3  # Euler steps of [dist]'s two Box2Video runs


def phase_dist(models, card: str) -> dict:
    """The multi-card paths (ctrlv_tpu_torch.parallel) at world 1 over NCCL, in
    this process (a FileStore under build/): the Box2Video sampler through its
    mesh= path and the ControlNet training step through its data-parallel
    update (ZeRO-1 asked for), each against the same call without a mesh; then
    the dry-run command with one spawned rank. World 1 must be exact: the same
    latents, loss, gradient norm and parameters to the bit and the same kernel
    launches, while the collective counters show that the mesh path called
    torch.distributed. Returns the mesh runs' launches."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    store = os.path.join(BUILD_DIR, "dist_rendezvous")
    if os.path.exists(store):
        os.remove(store)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    unet, ctrl, vae, clip = (models[k] for k in ("unet", "ctrl", "vae", "clip"))
    try:
        def counted(fn):
            torch.cuda.synchronize()
            _launch.reset_launch_counts()
            reset_collective_counts()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, dict(_launch.LAUNCHES), dict(COLLECTIVES), time.perf_counter() - t0

        image, cond = synthetic_request(4)

        def sample(mesh):
            pipe = StableVideoControlPipeline(unet, ctrl, vae, clip, mesh=mesh)
            return pipe(image, cond, generator=torch.Generator(device=DEVICE).manual_seed(4),
                        num_frames=FRAMES, num_inference_steps=DIST_STEPS,
                        min_guidance_scale=1.0, max_guidance_scale=3.0,
                        decode_chunk_size=CHUNK, output_type="latent")

        ref, ref_counts, ref_coll, ref_s = counted(lambda: sample(None))
        lat, counts, coll, secs = counted(lambda: sample(make_mesh(1, 1)))
        if not torch.equal(lat, ref) or counts != ref_counts:
            fail(f"[dist] the Box2Video mesh path differs from the plain one: latents equal "
                 f"{torch.equal(lat, ref)}, launches {counts} against {ref_counts}")
        if any(ref_coll.values()) or not coll["all_gather"]:
            fail(f"[dist] collectives: without a mesh {ref_coll}, with {coll}")
        print(f"[dist] Box2Video, {DIST_STEPS} steps at {W}x{H}x{FRAMES} on a 1x1 NCCL mesh: "
              f"latents bit-equal to the run without a mesh, launches {counts} equal, "
              f"collectives {coll}; {secs:.3f} s against {ref_s:.3f} s", flush=True)
        path_counts = dict(counts)

        # one ControlNet micro-step and its AdamW update (accumulation 1)
        start = {k: p.detach().clone() for k, p in ctrl.named_parameters()}
        unet.remat_block = ctrl.remat_block = True  # block checkpointing, as [train]
        gen = torch.Generator(device=DEVICE).manual_seed(7)
        clips, bbox = (2 * torch.rand((1, FRAMES, H, W, 3), generator=gen, device=DEVICE) - 1
                       for _ in range(2))

        def micro_step(mesh):
            with torch.no_grad():
                for k, p in ctrl.named_parameters():
                    p.copy_(start[k])
            tx = make_optimizer(learning_rate=1e-5, nan_guard_steps=0, mu_dtype="bfloat16")
            step = make_controlnet_train_step(unet, ctrl, vae, clip, tx,
                                              conditioning_dropout_prob=0.1,
                                              encode_chunk=ENCODE_CHUNK, mesh=mesh)
            state = init_train_state(ctrl.requires_grad_(True), tx)
            if mesh is not None:
                state = shard_train_state(state, mesh, zero1=True)
            state, metrics = step(state, clips, bbox,
                                  generator=torch.Generator(device=DEVICE).manual_seed(8))
            return ({k: float(v) for k, v in metrics.items()},
                    {k: p.detach().clone() for k, p in state.params.items()})

        (ref_m, ref_p), ref_counts, ref_coll, ref_s = counted(lambda: micro_step(None))
        (met, params), counts, coll, secs = counted(lambda: micro_step(make_train_mesh(1)))
        moved = sum(not torch.equal(ref_p[k], start[k]) for k in ref_p)
        same = all(torch.equal(params[k], ref_p[k]) for k in ref_p)
        if met != ref_m or not same or counts != ref_counts or not moved:
            fail(f"[dist] the data-parallel ControlNet step differs from the plain one: metrics "
                 f"{met} against {ref_m}, parameters equal {same} ({moved} moved), launches "
                 f"{counts} against {ref_counts}")
        if any(ref_coll.values()) or not coll["all_reduce"]:
            fail(f"[dist] collectives: without a mesh {ref_coll}, with {coll}")
        print(f"[dist] ControlNet micro-step + AdamW update on a 1x1 NCCL mesh (ZeRO-1 asked "
              f"for: one data rank slices nothing): loss {met['loss']:.6f} and grad norm "
              f"{met['grad_norm']:.6f} equal, {moved} of {len(ref_p)} tensors moved and all "
              f"bit-equal, launches equal, collectives {coll}; {secs:.3f} s against "
              f"{ref_s:.3f} s", flush=True)
        for k, v in counts.items():
            path_counts[k] += v
        del start, ref_p, params
    finally:
        unet.remat_block = ctrl.remat_block = False
        ctrl.requires_grad_(False)
        dist.destroy_process_group()
        torch.cuda.empty_cache()

    # the dry-run command as a user runs it: one rank of its own, NCCL
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "ctrlv_tpu_torch.tools.dryrun_multichip", "--nproc", "1",
           "--store_dir", BUILD_DIR]
    try:
        proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=180)
    except subprocess.TimeoutExpired:
        fail("[dist] dryrun_multichip ran past 180 s")
    line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    if proc.returncode != 0 or not line.startswith("dryrun_multichip ok: mesh=(1x1)"):
        print(proc.stdout[-4000:], proc.stderr[-4000:], flush=True)
        fail(f"[dist] dryrun_multichip exited {proc.returncode}")
    print(f"[dist] {line} ({time.perf_counter() - t0:.1f} s in its own process); card {card}",
          flush=True)
    return path_counts


def phase_train_svd(models, card: str) -> dict:
    """The stage-1 training step at full width in the temporal regime (this
    slice's main path): the bbox predictor (``predict_bbox``, three
    conditioning frames), only the temporal transformer blocks trained
    (``partitioned``), 1 x 25 frames at 512x320, device-random clips, "seq"
    layout, block checkpointing, encode chunk 5, AdamW (bf16 first moment, lr
    1e-5) under accumulation 2, K7 on. Then one full-finetune update at the
    same accumulation, to read its peak memory, and one VAE-decoder step."""
    t0 = time.perf_counter()
    with torch.device(DEVICE):
        unet = UNetSpatioTemporalConditionModel(UNET_CONFIG, gradient_checkpointing=True)
    unet.to(torch.bfloat16).load_state_dict(models["unet"].state_dict())
    unet.train()
    vae, clip = models["vae"], models["clip"]
    nets = dict(unet=unet, vae=vae, clip=clip)
    trainable = split_trainable(unet, temporal_blocks_predicate)
    opt_kw = dict(learning_rate=1e-5, nan_guard_steps=0, mu_dtype="bfloat16")
    step_kw = dict(predict_bbox=True, num_cond_bbox_frames=3, conditioning_dropout_prob=0.1,
                   encode_chunk=ENCODE_CHUNK)
    tx = MultiSteps(make_optimizer(**opt_kw), ACCUM)
    step = make_svd_train_step(unet, vae, clip, tx, partitioned=True, **step_kw)
    state = init_train_state(trainable, tx)
    probe_tx = KeepGradients()
    probe = make_svd_train_step(unet, vae, clip, probe_tx, partitioned=True, **step_kw)
    probe_state = init_train_state(trainable, probe_tx)
    n_train = sum(p.numel() for p in trainable.values())
    print(f"[train_svd] UNet built in {time.perf_counter() - t0:.1f} s; {n_train / 1e9:.3f} B "
          f"trainable parameters in {len(trainable)} tensors of the temporal transformer blocks, "
          f"of {sum(p.numel() for p in unet.parameters()) / 1e9:.3f} B in "
          f"{len(list(unet.parameters()))}", flush=True)

    gen = torch.Generator(device=DEVICE).manual_seed(8)
    scale = VAE_CONFIG.spatial_scale
    lat = (H // scale, W // scale, 4)
    clips, bbox = (2 * torch.rand((1, FRAMES, H, W, 3), generator=gen, device=DEVICE) - 1
                   for _ in range(2))
    normal = lambda *shape: torch.randn(shape, generator=gen, device=DEVICE)  # noqa: E731
    draws = {
        "latent_noise": normal(FRAMES, *lat), "rgb_init_noise": normal(1, *lat),
        "noise": normal(1, FRAMES, *lat), "sigma_idx": torch.tensor([500], device=DEVICE),
        "dropout_u": torch.tensor([0.9], device=DEVICE),  # keeps both conditionings
    }
    # the bbox clip in chunks and the first RGB frame; every block carries a graph
    # from the first temporal block on, so each runs twice
    encoder_calls = -(-FRAMES // ENCODE_CHUNK) + 1
    block_runs = [(b, lvl, 2) for b, lvl in blocks_by_level(unet)]

    micro_step = make_micro_step(clips, bbox, draws, resblock.set_fused_resblock, "K7 on", False)
    frozen = {k: {n: p.detach().clone() for n, p in nets[k].named_parameters()
                  if not (k == "unet" and temporal_blocks_predicate(n))}
              for k in nets}
    with launches_by_shape("train_svd", nets.values()):  # K4's and K5's launches by input shape
        _, metrics, secs, _ = micro_step(probe, probe_state, "K7 on")
    print(f"[train_svd] warm-up micro-step (under the shape hooks) {secs:.3f} s, loss "
          f"{check_metrics('warm-up', metrics)[0]:.4f}", flush=True)

    # Two optimizer updates at accumulation 2, K7 on: the main path's run.
    # K6 takes the one routed feed-forward before the first trained parameter,
    # the first down block's first spatial transformer block's, in both runs
    k6_ff = 2 * count_routed_ff(unet.down_blocks[0].attentions[0].transformer_blocks[0])
    expect = train_expected_launches(nets, block_runs, 1, lat[:2], encoder_calls, k6_ff=k6_ff,
                                     k7=True)
    updates = run_updates("train_svd", micro_step, step, state, tx, "K7 on", expect)
    state, path_counts = updates[:2]
    for k in nets:
        changed = [n for n, p in nets[k].named_parameters()
                   if n in frozen[k] and not torch.equal(p.detach(), frozen[k][n])]
        if changed:
            fail(f"frozen parameters of the {k} changed: {changed[:3]}")
    if any(p.requires_grad != temporal_blocks_predicate(n) for n, p in unet.named_parameters()):
        fail("a parameter outside the temporal transformer blocks asks for a gradient")
    del frozen

    off_expect = train_expected_launches(nets, block_runs, 1, lat[:2], encoder_calls,
                                         k6_ff=k6_ff)
    result = run_variants(micro_step, probe, probe_state, ("K7 on", "K7 off", "all plain"),
                          {"K7 on": expect, "K7 off": off_expect})
    # the query and key of a one-token cross-attention, and the norm in front of
    # it, are not reached by the loss; every other trained tensor must be
    unreached = (".attn2.to_q.", ".attn2.to_k.", ".norm2.")
    grads = result["K7 on"]["grads"]
    dead = [k for k, g in grads.items()
            if not any(u in k for u in unreached) and not float(g.abs().max()) > 0]
    stray = [k for k, g in grads.items()
             if any(u in k for u in unreached) and float(g.abs().max()) > 0]
    if dead or stray or set(grads) != set(trainable):
        fail(f"temporal parameters without a gradient: {dead[:3]}; unreached ones with one: "
             f"{stray[:3]}")

    report_variants("train_svd", f"temporal-regime micro-step, 1x{FRAMES} frames at {W}x{H}, "
                    f"predict_bbox, seq layout, block checkpointing, encode chunk {ENCODE_CHUNK}",
                    result, updates, card)
    print(f"[train_svd] {len(grads) - sum(any(u in k for u in unreached) for k in grads)} reached "
          f"tensors all with a gradient; the rest of the UNet, the VAE and CLIP bit-identical",
          flush=True)
    if not path_counts["resblock"]:
        fail("the stage-1 training path did not launch K7")
    del result, grads, probe_state, state, trainable, updates
    torch.cuda.empty_cache()

    # Full finetune: every UNet parameter, its gradient, the accumulator and two moments.
    full_tx = MultiSteps(make_optimizer(**opt_kw), ACCUM)
    full_step = make_svd_train_step(unet, vae, clip, full_tx, **step_kw)
    torch.cuda.reset_peak_memory_stats()
    full_state = init_train_state(unet.requires_grad_(True), full_tx)
    full_secs = []
    for i in range(ACCUM):
        full_state, metrics, secs, _ = micro_step(full_step, full_state, "K7 off")
        check_metrics(f"full finetune micro-step {i}", metrics)
        full_secs.append(secs)
    full_peak = torch.cuda.max_memory_allocated() / 2**30
    total = torch.cuda.get_device_properties(0).total_memory / 2**30
    print(f"[train_svd] full finetune, {len(full_state.params)} tensors, AdamW with a bf16 first "
          f"moment at accumulation {ACCUM}: micro-step {full_secs[0]:.3f} s, micro-step with its "
          f"update {full_secs[-1]:.3f} s, loss {metrics['loss'].item():.4f}; "
          f"max_memory_allocated {full_peak:.2f} GiB of the card's {total:.1f}; card {card}",
          flush=True)
    del full_state, full_tx, full_step
    unet.requires_grad_(False)
    torch.cuda.empty_cache()

    # VAE-decoder finetune: one step on 1 x 8 frames, a copy of the VAE.
    vae_train = copy.deepcopy(vae)
    vae_tx = make_optimizer(**opt_kw)
    vae_state = init_train_state(split_trainable(vae_train, vae_decoder_predicate), vae_tx)
    vae_step = make_vae_decoder_train_step(vae_train, vae_tx)
    before = {k: p.detach().clone() for k, p in vae_train.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _launch.reset_launch_counts()
    t1 = time.perf_counter()
    vae_state, metrics = vae_step(vae_state, clips[:, :CHUNK], generator=gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    loss = metrics["loss"].item()
    moved = [k for k, p in vae_train.named_parameters() if not torch.equal(p.detach(), before[k])]
    print(f"[train_svd] VAE-decoder step, 1x{CHUNK} frames at {W}x{H}: {secs:.3f} s, loss "
          f"{loss:.4f}, {len(moved)} of {len(vae_state.params)} decoder tensors moved, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
          f"{dict(_launch.LAUNCHES)}", flush=True)
    if not (np.isfinite(loss) and loss > 0 and moved):
        fail(f"VAE-decoder step: loss {loss}, {len(moved)} tensors moved")
    if not all(vae_decoder_predicate(k) for k in moved):
        fail(f"VAE-decoder step moved parameters outside the decoder: {moved[:3]}")
    return path_counts


# The eval entry point: synthetic requests answered, loader worker processes
EVAL_SAMPLES, EVAL_WORKERS = 2, 2
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")


def eval_expected_launches(overall: dict) -> dict:
    """A request of the eval tool launches what an ``[overall]`` request does,
    but its one UNet ("seq") takes stage 1's temporal attention to K2 where
    ``[overall]``'s frames-major stage-1 UNet takes it to K3."""
    exp = dict(overall)
    exp["small_mha"] += exp["small_mha_fm"]
    exp["small_mha_fm"] = 0
    return exp


def dir_gb(path: str) -> float:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path)
               for f in files) / 1e9


def write_random_checkpoint(ckpt: str):
    """Seeded random bf16 UNet-ST, VAE and CLIP written as a diffusers
    directory by the port's ``save_pipeline``; returns (the modules, GB,
    seconds to write)."""
    with torch.device(DEVICE):
        written = {"unet": UNetSpatioTemporalConditionModel(UNET_CONFIG),
                   "vae": AutoencoderKLTemporalDecoder(VAE_CONFIG),
                   "clip": CLIPVisionModelWithProjection(CLIP_CONFIG)}
    for seed, (key, m) in enumerate(written.items(), start=200):
        bench.init_random_(m, seed)
        written[key] = m.to(torch.bfloat16).eval()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_pipeline(ckpt, unet=written["unet"], vae=written["vae"], image_encoder=written["clip"])
    return written, dir_gb(ckpt), time.perf_counter() - t0


class CheckedPipeline:
    """A pipeline with each call's peak memory and launches read around it:
    its output checked by ``check``, its launches against ``expect``."""

    def __init__(self, pipe, name: str, expect: dict, check):
        self.pipe, self.name, self.expect, self.check = pipe, name, expect, check
        self.device = pipe.device
        self.calls = []  # (peak GiB, launches) a call

    def __call__(self, *args, **kwargs):
        torch.cuda.reset_peak_memory_stats()
        before = dict(_launch.LAUNCHES)
        res = self.pipe(*args, **kwargs)
        torch.cuda.synchronize()
        launches = {k: _launch.LAUNCHES[k] - before[k] for k in before}
        self.calls.append((torch.cuda.max_memory_allocated() / 2**30, launches))
        self.check(res)
        check_launches(f"{self.name} {len(self.calls) - 1}", launches, self.expect)
        return res


def phase_eval(card: str, overall: dict, ckpt: str) -> dict:
    """The overall-eval entry point (``ctrlv_tpu_torch.tools.eval_overall``) at
    full width: seeded random bf16 UNet-ST, VAE and CLIP written as a diffusers
    directory into ``ckpt`` with the port's ``save_pipeline`` (the later phases
    build from it too); the models built from it by the tool's
    ``build_models`` (strict, every tensor checked against the one written,
    bit for bit); then the tool's loop over two synthetic clips of 25 frames
    at 512x320 from ``get_dataloader`` with two worker processes, with the JAX
    tool's defaults (30 + 25 steps, decode chunk 8). Each request's output,
    scores and launches are checked; its launches are ``[overall]``'s with
    K3's taken by K2. Returns the launches of the whole loop."""
    written, gb, write_s = write_random_checkpoint(ckpt)
    cfg = Config(dataset_name="synthetic", data_root=ckpt, clip_length=FRAMES, train_H=H,
                 train_W=W, pretrained_model_name_or_path=ckpt, device=DEVICE,
                 dataloader_num_workers=EVAL_WORKERS, num_inference_steps=STAGE2_STEPS,
                 decode_chunk_size=CHUNK, num_demo_samples=EVAL_SAMPLES,
                 output_dir=os.path.join(ckpt, "out"), seed=5)
    t0 = time.perf_counter()
    models = tool_common.build_models(cfg, tiny=False, with_controlnet=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    print(f"[eval] checkpoint {gb:.3f} GB (UNet-ST, VAE, CLIP ViT-H in bf16): written in "
          f"{write_s:.3f} s ({gb / write_s:.2f} GB/s), built and loaded by build_models "
          f"in {load_s:.3f} s ({gb / load_s:.2f} GB/s); card {card}", flush=True)
    n_tensors = 0
    for key, src in written.items():
        got = models[key].state_dict()
        for name, t in src.state_dict().items():
            if got[name].dtype != t.dtype or not torch.equal(got[name], t):
                fail(f"the loaded {key} differs from the written one at {name}")
            n_tensors += 1
    print(f"[eval] {n_tensors} loaded tensors equal the written ones bit for bit", flush=True)
    del written
    torch.cuda.empty_cache()

    try:
        import PIL  # noqa: F401
        export = True
    except ImportError:
        export = False
        print("[eval] PIL cannot be imported here: the videos are not exported", flush=True)
    _, loader = get_dataloader(
        cfg.data_root, cfg.dataset_name, if_train=False, batch_size=1,
        num_workers=cfg.dataloader_num_workers, clip_length=FRAMES, shuffle=False,
        if_return_bbox_im=True, train_H=H, train_W=W, pin_memory=True)
    pipe = eval_overall.make_pipeline(models)

    def check(res):
        check_clip("the eval video", res["video"], (FRAMES, H, W, 3))
        check_clip("the eval bbox video", res["bbox_video"], (FRAMES, H, W, 3))
        scores = [res[k] for k in eval_overall.SCORES]
        if not all(isinstance(x, float) and 0.0 <= x <= 1.0 for x in scores):
            fail(f"eval scores {scores}")

    checked = CheckedPipeline(pipe, "eval request", eval_expected_launches(overall), check)
    _launch.reset_launch_counts()
    t0 = time.perf_counter()
    summary, samples = eval_overall.evaluate(checked, loader, cfg,
                                             max_samples=EVAL_SAMPLES, export=export)
    secs = time.perf_counter() - t0
    counts = dict(_launch.LAUNCHES)
    if len(samples) != EVAL_SAMPLES:
        fail(f"the eval loop answered {len(samples)} requests")
    for i, (sample, (peak, _)) in enumerate(zip(samples, checked.calls)):
        print(f"[eval] request {i}: {sample['seconds']:.3f} s, loader wait "
              f"{sample['loader_wait_seconds']:.3f} s, export "
              f"{sample['export_seconds']:.3f} s, best_guidance "
              f"{sample['best_guidance']}, " + ", ".join(
                  f"{k} {sample[k]:.4f}" for k in eval_overall.SCORES)
              + f"; max_memory_allocated {peak:.2f} GiB; card {card}", flush=True)
    if export:
        from ctrlv_tpu_torch.utils.video_io import load_video

        for i in range(EVAL_SAMPLES):
            for name in (f"generated_video_{i}.gif", f"predicted_bbox_{i}.gif"):
                video = load_video(os.path.join(cfg.output_dir, name))
                if video.shape[1:] != (H, W, 3):
                    fail(f"{name} has shape {video.shape}")
    print(f"[eval] {EVAL_SAMPLES} requests in {secs:.3f} s through {EVAL_WORKERS} loader "
          f"workers, summary {summary}, exported {export}; launches {counts}", flush=True)
    del models, pipe
    torch.cuda.empty_cache()
    return counts


# [train_cli]: micro-steps of the ControlNet trainer's first run (a
# checkpoint at CLI_CKPT) and of its resumed run, Euler steps of its one
# validation (at micro-step CLI_VAL; the tool's default is 25 steps), frames of
# the VAE trainer's one step (its decoder is not checkpointed)
CLI_STEPS, CLI_CKPT, CLI_VAL, CLI_RESUMED, CLI_VAL_STEPS, CLI_VAE_FRAMES = 4, 2, 3, 2, 5, CHUNK


def fingerprint(t: torch.Tensor) -> tuple:
    """Two sums over a tensor's bits, the second weighted by position: an
    element that changes changes them but for a vanishing share of changes."""
    bits = t.detach().reshape(-1).view({torch.float32: torch.int32,
                                        torch.bfloat16: torch.int16}[t.dtype]).long()
    weight = torch.arange(bits.numel(), device=t.device) % 65521 + 1
    return int(bits.sum()), int((bits * weight).sum())


class StepProbe:
    """Patched in place of a trainer tool's step factory: each micro-step's
    seconds and launches (synchronised around it), the optimizer update's
    seconds, and after each update how many trained tensors moved in master
    and in bf16. On its first micro-step each module tensor must be its
    master rounded."""

    def __init__(self, factory):
        self.factory, self.steps = factory, []

    def __call__(self, *args, **kwargs):
        tx = next(a for a in args if isinstance(a, MasterWeights))
        chain = tx.inner.inner if isinstance(tx.inner, MultiSteps) else tx.inner
        inner_update, update_secs = chain.update, []

        def timed_update(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner_update(*a)
            torch.cuda.synchronize()
            update_secs.append(time.perf_counter() - t0)
            return out

        chain.update = timed_update
        step, prints = self.factory(*args, **kwargs), {}

        def take(state):
            prints["master"] = {k: fingerprint(m) for k, m in state.opt_state["master"].items()}
            prints["bf16"] = {k: fingerprint(p) for k, p in state.params.items()}

        def probed(state, *a, **k):
            if not prints:
                bad = [n for n, p in state.params.items()
                       if not torch.equal(p, state.opt_state["master"][n].to(p.dtype))]
                if bad:
                    fail(f"module tensors that are not their masters rounded: {bad[:3]}")
                take(state)
            n_updates = len(update_secs)
            torch.cuda.synchronize()
            before = dict(_launch.LAUNCHES)
            t0 = time.perf_counter()
            state, metrics = step(state, *a, **k)
            torch.cuda.synchronize()
            rec = dict(secs=time.perf_counter() - t0, loss=metrics["loss"].item(),
                       launches={n: _launch.LAUNCHES[n] - before[n] for n in before})
            if len(update_secs) > n_updates:
                old = dict(prints)
                take(state)
                rec.update(update_secs=update_secs[-1], of=len(prints["master"]), **{
                    f"moved_{kind}": sum(prints[kind][n] != old[kind][n] for n in old[kind])
                    for kind in ("master", "bf16")})
            self.steps.append(rec)
            return state, metrics

        return probed


class TimedCheckpoints(CheckpointManager):
    """The trainers' ``CheckpointManager`` with each save's call (the host
    copy, and the write where it waits), each write in its thread and each
    restore timed; ``on_restore`` sees each restored tree."""
    records: list = []
    on_restore = None

    def save(self, step, tree, wait=False):
        t0 = time.perf_counter()
        saved = super().save(step, tree, wait=wait)
        if saved:
            self.records.append(("save", step, time.perf_counter() - t0))
        return saved

    def _write(self, step, skeleton, tensors):
        t0 = time.perf_counter()
        super()._write(step, skeleton, tensors)
        nbytes = sum(t.numel() * t.element_size() for t in tensors.values())
        self.records.append(("write", step, time.perf_counter() - t0, nbytes / 1e9))

    def restore(self, step=None, template=None):
        t0 = time.perf_counter()
        tree = super().restore(step, template)
        self.records.append(("restore", self.latest_step() if step is None else step,
                             time.perf_counter() - t0))
        if tree is not None and TimedCheckpoints.on_restore is not None:
            TimedCheckpoints.on_restore(tree)
        return tree


class UnwrittenFiles(TimedCheckpoints):
    """A ``TimedCheckpoints`` that takes each save's host copy and records its
    size but writes nothing, and (``export``) a ``save_pipeline`` that records
    the size of what it would write. The card's machine charges every byte
    written to its disk, deleted or not, against a limit that the whole script
    must stay under: the stage-1 trainer's 27 GB checkpoint and 15 GB of
    exports would pass it; the ControlNet trainer writes and reads back its
    own."""

    def _write(self, step, skeleton, tensors):
        nbytes = sum(t.numel() * t.element_size() for t in tensors.values())
        self.records.append(("write", step, 0.0, nbytes / 1e9))

    @staticmethod
    def export(out_dir, tensors=None, dtype=None, **modules):
        tensors = tensors or {}
        nbytes = 0
        for key, module in modules.items():
            if module is not None:
                for t in (tensors.get(key) or module.state_dict()).values():
                    nbytes += t.numel() * (t.element_size() if dtype is None or not
                                           t.is_floating_point() else dtype.itemsize)
        TimedCheckpoints.records.append(("export", out_dir, 0.0, nbytes / 1e9))
        return out_dir


@contextlib.contextmanager
def patched(module, **attrs):
    saved = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


def assert_trees_equal(got, want, path: str = "") -> int:
    """Two checkpoint trees equal to the bit; returns the tensors compared."""
    if isinstance(want, torch.Tensor):
        if got.dtype != want.dtype or not torch.equal(got.to(want.device), want):
            fail(f"{path} differs from the saved one")
        return 1
    if isinstance(want, dict):
        if sorted(got) != sorted(want):
            fail(f"{path}: keys differ")
        return sum(assert_trees_equal(got[k], want[k], f"{path}/{k}") for k in want)
    if isinstance(want, (list, tuple)):
        return sum(assert_trees_equal(a, b, f"{path}/{i}")
                   for i, (a, b) in enumerate(zip(got, want)))
    if got != want:
        fail(f"{path}: {got} against the saved {want}")
    return 0


def cli_loader(cfg: Config, bbox: bool):
    """The loader the trainer tools' ``main`` builds."""
    return get_dataloader(cfg.data_root, cfg.dataset_name, if_train=True,
                          batch_size=cfg.train_batch_size, num_workers=cfg.dataloader_num_workers,
                          clip_length=cfg.clip_length, if_return_bbox_im=bbox, train_H=cfg.train_H,
                          train_W=cfg.train_W, seed=cfg.seed, pin_memory=True)[1]


def report_steps(tag: str, probe: StepProbe, card: str) -> None:
    for i, r in enumerate(probe.steps):
        upd = (f", of which the update {r['update_secs']:.3f} s; moved: {r['moved_master']} "
               f"masters and {r['moved_bf16']} bf16 tensors of {r['of']}") if "update_secs" in r \
            else ""
        print(f"[train_cli] {tag} micro-step {i}: {r['secs']:.3f} s{upd}, loss {r['loss']:.4f}, "
              f"launches {r['launches']}; card {card}", flush=True)
        if "update_secs" in r and not (r["moved_master"] and r["moved_bf16"]):
            fail(f"{tag}: the update moved {r['moved_master']} masters, {r['moved_bf16']} bf16")


def check_steps(tag: str, probe: StepProbe, expect: dict, n: int) -> None:
    if len(probe.steps) != n:
        fail(f"{tag}: {len(probe.steps)} micro-steps, expected {n}")
    for i, r in enumerate(probe.steps):
        if r["launches"] != expect:
            fail(f"{tag} micro-step {i} launched {r['launches']}, expected {expect}")
        if not (np.isfinite(r["loss"]) and r["loss"] > 0):
            fail(f"{tag} micro-step {i}: loss {r['loss']}")


def phase_train_cli(card: str, train: dict, svd: str) -> dict:
    """The three trainer entry points (``ctrlv_tpu_torch.tools.train_*``) at
    full width, through each tool's own ``train(cfg, models, loader)`` on
    models that its ``build_models`` loads from the seeded random bf16
    checkpoint ``[eval]`` wrote into ``svd``, and synthetic clips of 25 frames
    at 512x320 from ``get_dataloader``: block checkpointing, encode chunk 5,
    AdamW with a bf16 first moment at lr 1e-5 without warm-up, under f32
    master weights.

    - ControlNet: accumulation 2, CLI_STEPS micro-steps with checkpoints at
      CLI_CKPT and at the end and one validation on one demo sample; then a
      second ``train`` from a fresh ``build_models`` with
      ``resume_from_checkpoint="latest"`` for CLI_RESUMED more, whose restored
      state must equal the saved one bit for bit; its export built back by
      ``build_models`` (strict) with every tensor equal to its master. Each
      micro-step launches what a ``[train]`` micro-step does;
    - stage 1: the bbox predictor as a full finetune with EMA, two updates at
      accumulation 2, launches as predicted from the module counts; its
      checkpoint and exports are counted, not written (``UnwrittenFiles``);
    - the VAE decoder: one step on CLI_VAE_FRAMES frames.

    Returns the launches of the micro-steps and the validation."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    root = tempfile.mkdtemp(prefix="train_cli_", dir=BUILD_DIR)
    usage = shutil.disk_usage(root)
    print(f"[train_cli] cuts: seeded random weights; {CLI_STEPS} + {CLI_RESUMED} ControlNet "
          f"micro-steps, its validation {CLI_VAL_STEPS} Euler steps (the tool's default 25); "
          f"stage 1 two updates, its checkpoint and exports not written; the VAE decoder one "
          f"step on {CLI_VAE_FRAMES} frames (it is not checkpointed); disk "
          f"{usage.free / 1e9:.0f} GB free of {usage.total / 1e9:.0f}", flush=True)
    path_counts = dict.fromkeys(_launch.LAUNCHES, 0)

    def add(counts):
        for k, v in counts.items():
            path_counts[k] += v

    try:
        common = dict(dataset_name="synthetic", data_root=root, clip_length=FRAMES, train_H=H,
                      train_W=W, pretrained_model_name_or_path=svd, device=DEVICE,
                      enable_gradient_checkpointing=True, vae_encode_chunk=ENCODE_CHUNK,
                      adam_mu_dtype="bfloat16", learning_rate=1e-5, lr_warmup_steps=0,
                      decode_chunk_size=CHUNK, num_demo_samples=1, seed=11)
        scale = VAE_CONFIG.spatial_scale
        lat = (H // scale, W // scale)

        # --- the ControlNet trainer, then its resumed run
        cfg = Config(output_dir=os.path.join(root, "controlnet"), max_train_steps=CLI_STEPS,
                     gradient_accumulation_steps=ACCUM, checkpointing_steps=CLI_CKPT,
                     validation_steps=CLI_VAL, num_inference_steps=CLI_VAL_STEPS, **common)
        ckpt_dir = os.path.join(cfg.output_dir, "checkpoints")
        val, run_validation = [], train_video_controlnet.run_validation

        def timed_validation(*args, **kwargs):
            torch.cuda.synchronize()
            before, t0 = dict(_launch.LAUNCHES), time.perf_counter()
            out = run_validation(*args, **kwargs)
            torch.cuda.synchronize()
            val.append((time.perf_counter() - t0,
                        {n: _launch.LAUNCHES[n] - before[n] for n in before}))
            return out

        runs = []
        for run in ("first", "resumed"):
            TimedCheckpoints.records = []
            probe = StepProbe(train_video_controlnet.make_controlnet_train_step)
            t0 = time.perf_counter()
            models = tool_common.build_models(cfg, tiny=False, with_controlnet=True,
                                              masters=("ctrl",))
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with patched(train_video_controlnet, make_controlnet_train_step=probe,
                         CheckpointManager=TimedCheckpoints,
                         run_validation=timed_validation):
                state = train_video_controlnet.train(cfg, models, cli_loader(cfg, True))
            torch.cuda.synchronize()
            runs.append(dict(secs=time.perf_counter() - t0, build_s=build_s, probe=probe,
                             peak=torch.cuda.max_memory_allocated() / 2**30,
                             records=list(TimedCheckpoints.records)))
            if run == "first":
                if state.step != CLI_STEPS or sorted(os.listdir(ckpt_dir)) != [
                        f"checkpoint-{CLI_CKPT}", f"checkpoint-{CLI_STEPS}"]:
                    fail(f"the ControlNet trainer: step {state.step}, {os.listdir(ckpt_dir)}")
                saved = CheckpointManager(ckpt_dir).restore(CLI_STEPS)
                n_saved = assert_trees_equal(tool_common.train_state_tree(state), saved)
                del models, state
                torch.cuda.empty_cache()

                def check_restored(tree):
                    n = assert_trees_equal(tree, saved)
                    print(f"[train_cli] resumed: the restored masters, moments, accumulated "
                          f"gradient, counters and step equal the saved ones bit for bit "
                          f"({n} tensors, step {tree['step']})", flush=True)

                TimedCheckpoints.on_restore = check_restored
                cfg = dataclasses.replace(cfg, max_train_steps=CLI_STEPS + CLI_RESUMED,
                                          resume_from_checkpoint="latest")
        TimedCheckpoints.on_restore = None
        del saved
        if state.step != CLI_STEPS + CLI_RESUMED or not any(r[0] == "restore"
                                                           for r in runs[1]["records"]):
            fail(f"the resumed ControlNet trainer ended at step {state.step} without a restore")
        expect = {k: v // (2 * ACCUM) for k, v in train.items()}
        for run, tag in zip(runs, ("ControlNet", "ControlNet resumed")):
            check_steps(tag, run["probe"], expect, CLI_STEPS if tag == "ControlNet" else CLI_RESUMED)
            report_steps(tag, run["probe"], card)
            for r in run["probe"].steps:
                add(r["launches"])
        nets = dict(unet=models["unet"], ctrl=models["ctrl"], vae=models["vae"],
                    clip=models["clip"])
        val_expect = expected_launches(
            nets, {"clip": 1, "enc": 2, "dec": decode_calls(FRAMES, CHUNK, None),
                   "ctrl": CLI_VAL_STEPS, "unet": CLI_VAL_STEPS},
            {"ctrl": ("small_mha", False), "unet": ("small_mha", False)})
        if len(val) != 1 or val[0][1] != val_expect:
            fail(f"the ControlNet trainer's validations: {val}, expected one of {val_expect}")
        add(val[0][1])
        media = os.path.join(cfg.output_dir, "media", "videos", f"step_{CLI_VAL}")
        if sorted(os.listdir(media)) != ["generated_videos_0.gif", "gt_bbox_frames_0.gif",
                                         "gt_videos_0.gif"]:
            fail(f"the validation's media: {os.listdir(media)}")
        with open(os.path.join(cfg.output_dir, "logs", "metrics.jsonl")) as f:
            logged = [json.loads(line)["step"] for line in f]
        if logged != list(range(1, CLI_STEPS + CLI_RESUMED + 1)):
            fail(f"metrics.jsonl holds steps {logged}")

        # the export, built back strictly
        export = os.path.join(cfg.output_dir, "pipeline", "control_net")
        masters = state.opt_state["master"]
        for name, t in iter_tensors(os.path.join(export, "diffusion_pytorch_model.safetensors")):
            if t.dtype != torch.float32 or not torch.equal(t.to(DEVICE), masters[name]):
                fail(f"the exported {name} is not its master")
        export_gb = dir_gb(export)
        del models, state, masters, nets
        torch.cuda.empty_cache()
        back = tool_common.build_models(
            Config(pretrained_model_name_or_path=os.path.dirname(export), mixed_precision="no",
                   device=DEVICE), tiny=False, with_controlnet=True)
        load_hf_component(export, back["ctrl"], strict=True)
        print(f"[train_cli] the {export_gb:.3f} GB f32 export built back by build_models and "
              f"loaded strictly; every tensor equal to its master bit for bit", flush=True)
        del back
        torch.cuda.empty_cache()
        for run, tag in zip(runs, ("first run", "resumed run")):
            steps = run["probe"].steps
            plain = [r["secs"] for r in steps if "update_secs" not in r]
            updates = [r["update_secs"] for r in steps if "update_secs" in r]
            saves = [r for r in run["records"] if r[0] == "write"]
            calls = [r for r in run["records"] if r[0] == "save"]
            restores = [r for r in run["records"] if r[0] == "restore"]
            ckpt_gb = saves[-1][3]
            print(f"[train_cli] ControlNet trainer, {tag}: {run['secs']:.3f} s in train() "
                  f"(build_models {run['build_s']:.3f} s); s/micro-step without an update "
                  f"{', '.join(f'{x:.3f}' for x in plain)}; s/update "
                  f"{', '.join(f'{x:.3f}' for x in updates)}; checkpoint {ckpt_gb:.3f} GB: "
                  + ", ".join(f"step {r[1]} written in {r[2]:.3f} s ({r[3] / r[2]:.2f} GB/s)"
                              for r in saves)
                  + "; save() calls " + ", ".join(f"{r[2]:.3f} s" for r in calls)
                  + "".join(f"; restored in {r[2]:.3f} s ({ckpt_gb / r[2]:.2f} GB/s)"
                            for r in restores)
                  + f"; max_memory_allocated {run['peak']:.2f} GiB; card {card}", flush=True)
        print(f"[train_cli] ControlNet validation, {CLI_VAL_STEPS} Euler steps, 1x{FRAMES} frames "
              f"at {W}x{H}: {val[0][0]:.3f} s (with its three GIFs), launches {val[0][1]}",
              flush=True)
        shutil.rmtree(cfg.output_dir)

        # --- the stage-1 trainer: the bbox predictor as a full finetune with EMA
        cfg1 = Config(output_dir=os.path.join(root, "stage1"), max_train_steps=2 * ACCUM,
                      gradient_accumulation_steps=ACCUM, checkpointing_steps=2 * ACCUM,
                      validation_steps=0, predict_bbox=True, use_ema=True, **common)
        probe = StepProbe(train_video_diffusion.make_svd_train_step)
        TimedCheckpoints.records = []
        models = tool_common.build_models(cfg1, tiny=False, masters=("unet",))
        unet = models["unet"]
        nets = dict(unet=unet, vae=models["vae"], clip=models["clip"])
        # every UNet parameter trains: every block carries a graph and runs twice;
        # no feed-forward is without a gradient, so K6 takes none
        expect1 = train_expected_launches(nets, [(b, lvl, 2) for b, lvl in blocks_by_level(unet)],
                                          1, lat, -(-FRAMES // ENCODE_CHUNK) + 1)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with patched(train_video_diffusion, make_svd_train_step=probe,
                     CheckpointManager=UnwrittenFiles, save_pipeline=UnwrittenFiles.export):
            state = train_video_diffusion.train(cfg1, models, cli_loader(cfg1, True))
        torch.cuda.synchronize()
        secs, peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30
        check_steps("stage 1", probe, expect1, 2 * ACCUM)
        report_steps("stage 1", probe, card)
        for r in probe.steps:
            add(r["launches"])
        write = [r for r in TimedCheckpoints.records if r[0] == "write"][-1]
        save = [r for r in TimedCheckpoints.records if r[0] == "save"][-1]
        exports = [r[3] for r in TimedCheckpoints.records if r[0] == "export"]
        n_train = sum(m.numel() for m in state.opt_state["master"].values())
        total = torch.cuda.get_device_properties(0).total_memory / 2**30
        print(f"[train_cli] stage-1 trainer (predict_bbox, full finetune, EMA, {n_train / 1e9:.3f} "
              f"B f32 masters in {len(state.params)} tensors): {secs:.3f} s in train(); "
              f"s/micro-step without an update "
              f"{', '.join(f'{r['secs']:.3f}' for r in probe.steps if 'update_secs' not in r)}; "
              f"s/update {', '.join(f'{r['update_secs']:.3f}' for r in probe.steps if 'update_secs' in r)}; "
              f"checkpoint {write[3]:.3f} GB, its host copy {save[2]:.3f} s, not written; exports "
              f"{' + '.join(f'{gb:.3f}' for gb in exports)} GB, not written; "
              f"max_memory_allocated {peak:.2f} GiB of {total:.1f}; card {card}", flush=True)
        del models, state, unet, nets
        torch.cuda.empty_cache()

        # --- the VAE-decoder trainer: one step
        cfgv = Config(output_dir=os.path.join(root, "vae"), max_train_steps=1,
                      validation_steps=0, **dict(common, clip_length=CLI_VAE_FRAMES))
        probe = StepProbe(train_vae_finetuning.make_vae_decoder_train_step)
        models = tool_common.build_models(cfgv, tiny=False, masters=("vae",))
        torch.cuda.reset_peak_memory_stats()
        with patched(train_vae_finetuning, make_vae_decoder_train_step=probe):
            state = train_vae_finetuning.train(cfgv, models, cli_loader(cfgv, False))
        torch.cuda.synchronize()
        report_steps("VAE decoder", probe, card)
        if len(probe.steps) != 1 or not all(k.startswith("decoder.") for k in state.params):
            fail(f"the VAE trainer: {len(probe.steps)} steps")
        add(probe.steps[0]["launches"])
        print(f"[train_cli] VAE-decoder trainer, 1x{CLI_VAE_FRAMES} frames at {W}x{H}: "
              f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"card {card}", flush=True)
        del models, state
        torch.cuda.empty_cache()
        return path_counts
    finally:
        TimedCheckpoints.on_restore = None
        shutil.rmtree(root, ignore_errors=True)


# [eval_metrics]: clips of the two sampling eval commands; seeds of the I3D and
# LPIPS weights of the offline eval
METRICS_SAMPLES, I3D_SEED, LPIPS_SEED = 2, 31, 32
# |card - CPU| of the I3D's features and LPIPS's distances, relative L2: the same
# IEEE f32 arithmetic in cuDNN's order of sums
METRICS_TOL = 1e-4


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def phase_eval_metrics(card: str, ckpt: str) -> dict:
    """The evaluation-metric commands at full width, on models that the
    tools' ``build_models`` loads from the seeded random bf16 checkpoint
    ``[eval]`` wrote into ``ckpt``:

    1. the stage-1 eval (``tools.eval_video_bbox_prediction.evaluate``) over
       METRICS_SAMPLES synthetic clips from ``get_dataloader`` with two worker
       processes: 25 frames at 512x320, 25 steps, CFG 1 -> 3, decode chunk 8;
       frames, scores and each clip's launches (those of a 25-step
       ``VideoDiffusionPipeline`` call) checked;
    2. the generation eval (``tools.eval_video_generation.evaluate``) over the
       same clips with ``compute_fvd=True``: the I3D at its published widths
       on 25 frames at 224x224 in f32, timed alone beside its bound, and with
       TF32 on for how far that moves the features;
    3. the offline eval (``metrics.offline_eval.evaluate_media_dir``) of the
       directory step 2 exported, with seeded I3D and LPIPS weights at the
       JAX defaults (11 frames, 2x temporal downsample, 410x256), the time
       split into GIF decode and the rest; then the card's I3D features and
       LPIPS distances of those frames against the same modules on the CPU.

    Returns the launches of the two sampling loops."""
    from torch.utils.flop_counter import FlopCounterMode

    from ctrlv_tpu_torch.metrics import fvd as fvd_mod
    from ctrlv_tpu_torch.metrics import lpips as lpips_mod
    from ctrlv_tpu_torch.metrics import offline_eval
    from ctrlv_tpu_torch.metrics.common import ieee_f32

    os.makedirs(BUILD_DIR, exist_ok=True)
    root = tempfile.mkdtemp(prefix="eval_metrics_", dir=BUILD_DIR)
    print(f"[eval_metrics] cuts: seeded random weights (UNet-ST, VAE, CLIP, I3D, LPIPS); "
          f"{METRICS_SAMPLES} synthetic clips a command", flush=True)
    try:
        cfg = Config(dataset_name="synthetic", data_root=root, clip_length=FRAMES, train_H=H,
                     train_W=W, pretrained_model_name_or_path=ckpt, device=DEVICE,
                     dataloader_num_workers=EVAL_WORKERS, num_inference_steps=STAGE2_STEPS,
                     decode_chunk_size=CHUNK, num_demo_samples=METRICS_SAMPLES, seed=7,
                     min_guidance_scale=1.0, max_guidance_scale=3.0)
        models = tool_common.build_models(cfg, tiny=False)
        paths = {}
        for path, tool, bbox in (("eval_bbox", eval_video_bbox_prediction, True),
                                 ("eval_gen", eval_video_generation, False)):
            cfg = dataclasses.replace(cfg, output_dir=os.path.join(root, path))
            expect = expected_launches(
                models, {"clip": 1, "enc": 2 if bbox else 1, "unet": STAGE2_STEPS,
                         "dec": decode_calls(FRAMES, CHUNK, None)},
                {"unet": ("small_mha", False)})
            pipe = CheckedPipeline(
                tool.make_pipeline(models), f"the {path} clip", expect,
                lambda out: check_clip("the eval_metrics clip", out, (1, FRAMES, H, W, 3)))
            _, loader = get_dataloader(
                cfg.data_root, cfg.dataset_name, if_train=False, batch_size=1,
                num_workers=EVAL_WORKERS, clip_length=FRAMES, shuffle=False,
                if_return_bbox_im=bbox, train_H=H, train_W=W, pin_memory=True)
            _launch.reset_launch_counts()
            t0 = time.perf_counter()
            summary, samples = tool.evaluate(pipe, loader, cfg, max_samples=METRICS_SAMPLES,
                                             **({} if bbox else {"compute_fvd": True}))
            secs = time.perf_counter() - t0
            paths[path] = dict(_launch.LAUNCHES)
            if len(samples) != METRICS_SAMPLES:
                fail(f"{path} answered {len(samples)} clips")
            for i, (s, (peak, _)) in enumerate(zip(samples, pipe.calls)):
                scores = {k: s[k] for k in ("miou", "f_measure") if k in s}
                if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in scores.values()):
                    fail(f"{path} clip {i}: scores {scores}")
                extra = (f"scoring {s['scoring_seconds']:.3f} s, " if bbox
                         else f"I3D of the pair (with its preprocessing) {s['fvd_seconds']:.3f} s, ")
                print(f"[eval_metrics] {path} clip {i}: {s['seconds']:.3f} s/clip, loader wait "
                      f"{s['loader_wait_seconds']:.3f} s, {extra}export {s['export_seconds']:.3f} "
                      f"s, {scores}; max_memory_allocated {peak:.2f} GiB; card {card}",
                      flush=True)
            if not bbox and not np.isfinite(summary["fvd"]):
                fail(f"the generation eval's FVD is {summary['fvd']}")
            print(f"[eval_metrics] {path}: {METRICS_SAMPLES} clips in {secs:.3f} s, summary "
                  f"{summary}; launches {paths[path]}", flush=True)
        gen_dir = cfg.output_dir
        del models, pipe
        torch.cuda.empty_cache()

        # The I3D alone, on a 25-frame clip at 512x320 resized and cropped to 224x224
        from ctrlv_tpu_torch.utils.video_io import load_video

        _, clip = synthetic_request(4)
        i3d_sd = fvd_mod.FVD(device="cpu", seed=I3D_SEED).model.state_dict()
        fvd = fvd_mod.FVD(state_dict=i3d_sd, device=DEVICE)
        x = fvd_mod.preprocess_fvd(clip.to(DEVICE) / 2 + 0.5).permute(0, 4, 1, 2, 3).contiguous()
        with torch.no_grad():
            with FlopCounterMode(display=False) as counter:
                fvd.model(x)
            flops = counter.get_total_flops()
            n_params = sum(p.numel() for p in fvd.model.parameters())
            bound_ms = 1e3 * max((x.numel() + n_params + 400) * 4 / PEAK_BYTES, flops / PEAK_F32)
            with ieee_f32():
                ms = cuda_time_ms(lambda: fvd.model(x), reps=5, warmup=2)
                feats = fvd.model(x).cpu().numpy()
            # outside ieee_f32, the switches [device] set: TF32 on
            tf32_ms = cuda_time_ms(lambda: fvd.model(x), reps=5, warmup=2)
            tf32 = rel_l2(fvd.model(x).cpu().numpy(), feats)
        print(f"[eval_metrics] I3D on (1, 3, {FRAMES}, 224, 224) f32: {ms:.3f} ms/clip, "
              f"{flops / 1e9:.1f} GFLOP, bound {bound_ms:.3f} ms at {PEAK_F32 / 1e12:.0f} TFLOP/s "
              f"f32; TF32 on: {tf32_ms:.3f} ms, features moved by {tf32:.2e} relative L2; "
              f"card {card}", flush=True)

        # The offline eval of the generation eval's directory
        lpips_sd = lpips_mod.lpips_init_params(LPIPS_SEED)
        decode = []

        def timed_load(path):
            t = time.perf_counter()
            out = load_video(path)
            decode.append(time.perf_counter() - t)
            return out

        t0 = time.perf_counter()
        with patched(offline_eval, load_video=timed_load):
            res = offline_eval.evaluate_media_dir(gen_dir, fvd_state_dict=i3d_sd,
                                                  lpips_state_dict=lpips_sd, device=DEVICE)
        secs = time.perf_counter() - t0
        if res["num_pairs"] != METRICS_SAMPLES or not all(
                np.isfinite(res[k]) for k in ("fvd", "ssim", "psnr", "lpips")):
            fail(f"the offline eval gave {res}")
        print(f"[eval_metrics] offline eval of {res['num_pairs']} pairs (11 frames, 2x temporal "
              f"downsample, 410x256): fvd {res['fvd']:.6g} ssim {res['ssim']:.4f} psnr "
              f"{res['psnr']:.3f} lpips {res['lpips']:.4f}; {secs:.3f} s = GIF decode "
              f"{sum(decode):.3f} s + the rest (the networks' set-up, the card's work, the scores) "
              f"{secs - sum(decode):.3f} s; card {card}", flush=True)

        # Card against CPU, the same weights on the same frames, pair by pair
        cpu_fvd = fvd_mod.FVD(state_dict=i3d_sd, device="cpu")
        lp_cpu = lpips_mod.build_lpips(lpips_sd, "cpu")
        lp = lpips_mod.build_lpips(lpips_sd, DEVICE)
        got = {k: [] for k in ("feats", "feats_cpu", "feats_tf32", "d", "d_cpu", "d_tf32")}
        for pair in offline_eval.pair_video_files(gen_dir):
            gen, gt = (offline_eval._prepare(load_video(p), (410, 256), 11, True, "cpu")
                       for p in pair)
            n = min(len(gen), len(gt))
            videos, a, b = torch.stack([gt[:n], gen[:n]]), gen[:n] * 2 - 1, gt[:n] * 2 - 1
            got["feats_cpu"].append(cpu_fvd.features(videos))
            got["feats"].append(fvd.features(videos))
            got["d_cpu"].append(lpips_mod.lpips_distance(lp_cpu, a, b).numpy())
            got["d"].append(lpips_mod.lpips_distance(lp, a, b).cpu().numpy())
            with patched(fvd_mod, ieee_f32=contextlib.nullcontext), \
                    patched(lpips_mod, ieee_f32=contextlib.nullcontext):
                got["feats_tf32"].append(fvd.features(videos))
                got["d_tf32"].append(lpips_mod.lpips_distance(lp, a, b).cpu().numpy())
        feats, feats_cpu, feats_tf32, d, d_cpu, d_tf32 = (
            np.concatenate(got[k]) for k in ("feats", "feats_cpu", "feats_tf32", "d", "d_cpu",
                                             "d_tf32"))
        errs = {"i3d": rel_l2(feats, feats_cpu), "lpips": rel_l2(d, d_cpu)}
        print(f"[eval_metrics] card against CPU, f32: I3D features ({feats.shape[0]} clips) "
              f"{errs['i3d']:.2e}, LPIPS distances ({d.shape[0]} frame pairs) {errs['lpips']:.2e} "
              f"relative L2 (limit {METRICS_TOL:g}); with TF32 on the card: "
              f"{rel_l2(feats_tf32, feats_cpu):.2e} and {rel_l2(d_tf32, d_cpu):.2e}; card {card}",
              flush=True)
        if not all(e <= METRICS_TOL for e in errs.values()):
            fail(f"the metrics on the card differ from the CPU's: {errs}")
        return paths
    finally:
        shutil.rmtree(root, ignore_errors=True)


# [teaser]: 12 Hz CAM_FRONT frames of the one nuScenes scene (every second one
# is kept at 7 Hz: 25 frames, one validation clip), keyframes every sixth, the
# real CAM_FRONT intrinsics (1600x900); the teaser tool's seeds a clip
# the tool draws NUM_SEEDS = 3 seeds a clip; two keep the run inside its time
# limit beside [dist] (the third repeats the same request with another seed)
TEASER_RAW_FRAMES, TEASER_KEY_EVERY, TEASER_SEEDS = 49, 6, 2
NUSC_INTRINSIC = [[1266.417, 0.0, 816.267], [0.0, 1266.417, 491.507], [0.0, 0.0, 1.0]]
# instance: (category, size w l h, centre (x, y, z) at keyframe 0, its velocity
# a keyframe, yaw a keyframe in radians, the keyframes it is annotated at)
NUSC_INSTANCES = {
    "car_a": ("vehicle.car", (1.9, 4.6, 1.6), (-3.0, 1.0, 14.0), (0.4, 0.0, 2.5), 0.05, range(9)),
    "car_b": ("vehicle.car", (1.8, 4.3, 1.5), (4.0, 1.0, 30.0), (-0.2, 0.0, -1.5), 0.0, range(9)),
    "truck": ("vehicle.truck", (2.5, 8.0, 3.2), (9.0, 0.5, 40.0), (0.0, 0.0, -2.0), -0.02,
              range(2, 9)),
    "ped": ("human.pedestrian.adult", (0.6, 0.7, 1.8), (-6.0, 1.0, 12.0), (0.3, 0.0, 0.0), 0.0,
            range(0, 6)),
    "cone": ("movable_object.trafficcone", (0.4, 0.4, 0.8), (2.5, 1.5, 9.0), (0.0, 0.0, 0.0), 0.0,
             range(9)),
}


def write_nuscenes_tree(root: str, raw_frames: int = TEASER_RAW_FRAMES) -> None:
    """A nuScenes v1.0-trainval tree under ``root/nuscenes``: one scene of
    ``raw_frames`` CAM_FRONT JPEGs at 1600x900 and 12 Hz, keyframes at 2 Hz,
    the sweeps between them pointing at the next keyframe, identity ego and
    sensor poses, the real CAM_FRONT intrinsics, and the NUSC_INSTANCES moving
    and turning from keyframe to keyframe; the scene in both the train and the
    val split (``splits.json``)."""
    from PIL import Image

    base = os.path.join(root, "nuscenes")
    tdir, idir = os.path.join(base, "v1.0-trainval"), os.path.join(base, "samples", "CAM_FRONT")
    os.makedirs(tdir)
    os.makedirs(idir)
    ident = [1.0, 0.0, 0.0, 0.0]
    keys = list(range(0, raw_frames, TEASER_KEY_EVERY))
    samples = [f"s{k}" for k in range(len(keys))]
    tables = dict(
        sensor=[dict(token="cam", channel="CAM_FRONT", modality="camera")],
        calibrated_sensor=[dict(token="cs", sensor_token="cam", translation=[0.0, 0.0, 0.0],
                                rotation=ident, camera_intrinsic=NUSC_INTRINSIC)],
        scene=[dict(token="scene", name="scene-0001", first_sample_token=samples[0],
                    last_sample_token=samples[-1], nbr_samples=len(samples), description="",
                    log_token="")],
        sample=[dict(token=tok, timestamp=keys[k] * 83_333, scene_token="scene",
                     prev=samples[k - 1] if k else "",
                     next=samples[k + 1] if k + 1 < len(samples) else "")
                for k, tok in enumerate(samples)],
        category=[], instance=[], sample_annotation=[], sample_data=[], ego_pose=[],
    )
    for name, (cat, size, c0, vel, yaw, at) in NUSC_INSTANCES.items():
        tables["category"].append(dict(token=f"cat_{name}", name=cat, description=""))
        tables["instance"].append(dict(token=name, category_token=f"cat_{name}"))
        for k in at:
            theta = yaw * k
            tables["sample_annotation"].append(dict(
                token=f"{name}_{k}", sample_token=samples[k], instance_token=name,
                visibility_token="4", attribute_tokens=[], size=list(size),
                translation=[c + v * k for c, v in zip(c0, vel)],
                rotation=[math.cos(theta / 2), 0.0, math.sin(theta / 2), 0.0],
                prev="", next="", num_lidar_pts=1, num_radar_pts=1))
    ys, xs = np.mgrid[0:900, 0:1600]
    for i in range(raw_frames):
        k = min(-(-i // TEASER_KEY_EVERY), len(samples) - 1)  # a sweep's next keyframe
        ts = i * 83_333
        fname = f"samples/CAM_FRONT/f{i:03d}.jpg"
        img = np.stack([(xs + 7 * i) % 256, ys * 255 // 900, np.full_like(xs, 60 + i)], -1)
        img[400:600, 200 + 10 * i:500 + 10 * i] = (200, 40, 40)
        Image.fromarray(img.astype(np.uint8)).save(os.path.join(base, fname), quality=90)
        tables["ego_pose"].append(dict(token=f"ego{i}", timestamp=ts, rotation=ident,
                                       translation=[0.0, 0.0, 0.0]))
        tables["sample_data"].append(dict(
            token=f"sd{i}", sample_token=samples[k], ego_pose_token=f"ego{i}",
            calibrated_sensor_token="cs", timestamp=ts, fileformat="jpg",
            is_key_frame=i % TEASER_KEY_EVERY == 0, height=900, width=1600, filename=fname,
            prev=f"sd{i - 1}" if i else "", next=f"sd{i + 1}" if i + 1 < raw_frames else ""))
    for name, records in tables.items():
        with open(os.path.join(tdir, f"{name}.json"), "w") as f:
            json.dump(records, f)
    with open(os.path.join(tdir, "splits.json"), "w") as f:
        json.dump({"train": ["scene-0001"], "val": ["scene-0001"], "test": []}, f)


def write_davis_tree(root: str, frames: int = 8) -> None:
    """A DAVIS 2017 tree under ``root/DAVIS``: two 480p sequences of
    ``frames`` JPEGs at 854x480, the first with indexed masks of two objects
    (one moving), both in the train split."""
    from PIL import Image

    for seq in ("bear", "boat"):
        img_dir = os.path.join(root, "DAVIS", "JPEGImages", "480p", seq)
        ann_dir = os.path.join(root, "DAVIS", "Annotations", "480p", seq)
        os.makedirs(img_dir)
        os.makedirs(ann_dir)
        for i in range(frames):
            Image.new("RGB", (854, 480), (10, 120 + 10 * i, 60)).save(
                os.path.join(img_dir, f"{i:05d}.jpg"))
            if seq == "bear":
                mask = np.zeros((480, 854), np.uint8)
                mask[100:300, 200 + 20 * i:500 + 20 * i] = 1
                mask[350:450, 50:250] = 2
                Image.fromarray(mask, mode="L").save(os.path.join(ann_dir, f"{i:05d}.png"))
    sets = os.path.join(root, "DAVIS", "ImageSets", "2017")
    os.makedirs(sets)
    with open(os.path.join(sets, "train.txt"), "w") as f:
        f.write("bear\nboat\n")


def phase_teaser(card: str, overall: dict, ckpt: str) -> dict:
    """The data tools and the teaser tool on a nuScenes tree and a DAVIS tree
    this phase writes (``write_nuscenes_tree``, ``write_davis_tree``):

    1. ``tools.preprocess_dataset`` over the nuScenes tree: each of the 25
       training frames' ``my_render_3d_style`` box image at 512x320, by token;
    2. ``tools.dataset_examples`` over the tree: one batch of each present
       dataset (synthetic, DAVIS) on the card, the rest unavailable;
    3. ``tools.draw_teaser.main`` over the nuScenes validation clip (25 frames
       at 512x320, 30 + 25 steps, decode chunk 8, two loader workers) on the
       models its ``build_models`` loads from the seeded random bf16
       checkpoint ``[eval]`` wrote into ``ckpt``: three overall requests, each
       request's launches checked against ``[eval]``'s, the files it writes,
       and its ground-truth plots at 900x1600 (white: a nuScenes sample
       carries no calibration and the 2D boxes are BDD100K's, in both
       packages), then the same plots with the 2D boxes drawn, whose last
       must differ from the first.

    Prints s/request, the loader's first wait and an item's host seconds,
    the export and plot seconds and peak memory; returns the launches of the
    three requests."""
    from ctrlv_tpu_torch.data import build_dataset, collate_clip_batch
    from ctrlv_tpu_torch.tools import dataset_examples, draw_teaser, preprocess_dataset
    from ctrlv_tpu_torch.utils.misc import render_gt_3d_bbox_plots
    from ctrlv_tpu_torch.utils.video_io import load_video
    from PIL import Image

    t_phase = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    root = tempfile.mkdtemp(prefix="teaser_", dir=BUILD_DIR)
    try:
        t0 = time.perf_counter()
        write_nuscenes_tree(root)
        write_davis_tree(root)
        print(f"[teaser] nuScenes tree ({TEASER_RAW_FRAMES} CAM_FRONT JPEGs at 1600x900, 12 Hz, "
              f"{len(NUSC_INSTANCES)} instances) and DAVIS tree written in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        cfg = Config(dataset_name="nuscenes", data_root=root, clip_length=FRAMES, train_H=H,
                     train_W=W, pretrained_model_name_or_path=ckpt, device=DEVICE,
                     dataloader_num_workers=EVAL_WORKERS, num_inference_steps=STAGE2_STEPS,
                     decode_chunk_size=CHUNK, seed=9, output_dir=os.path.join(root, "out"))

        t0 = time.perf_counter()
        n = preprocess_dataset.main(cfg)
        pre_s = time.perf_counter() - t0
        pngs = sorted(os.listdir(os.path.join(cfg.output_dir, "bbox_frames")))
        if n != (TEASER_RAW_FRAMES + 1) // 2 or len(pngs) != n:  # every second frame at 7 Hz
            fail(f"tools.preprocess_dataset drew {n} frames and wrote {len(pngs)}")
        frame = np.asarray(Image.open(os.path.join(cfg.output_dir, "bbox_frames", pngs[0])))
        if frame.shape != (H, W, 3) or not (frame > 0).any():
            fail(f"a preprocessed box frame: shape {frame.shape}, drawn {(frame > 0).any()}")
        print(f"[teaser] tools.preprocess_dataset: {n} nuScenes box frames at {W}x{H} in "
              f"{pre_s:.3f} s", flush=True)

        t0 = time.perf_counter()
        lines = dataset_examples.main(cfg)
        ex_s = time.perf_counter() - t0
        present = {line.split(":")[0] for line in lines if " samples, clips=" in line}
        if present != {"synthetic", "davis"} or len(lines) != 6:
            fail(f"tools.dataset_examples found {sorted(present)}: {lines}")
        print(f"[teaser] tools.dataset_examples: {len(lines)} lines in {ex_s:.3f} s", flush=True)

        # an item's host seconds in this process, beside the loader's first wait
        ds = build_dataset("nuscenes", root, False, clip_length=FRAMES, if_return_bbox_im=True,
                           train_H=H, train_W=W)
        t0 = time.perf_counter()
        item = ds[0]
        item_s = time.perf_counter() - t0
        if len(ds) != 1 or item["bbox_images"].shape != (FRAMES, H, W, 3):
            fail(f"the nuScenes validation split holds {len(ds)} clips")

        sums = []  # a video's sum a seed: the seeds must give different videos

        def check(res):
            check_clip("the teaser video", res["video"], (FRAMES, H, W, 3))
            check_clip("the teaser bbox video", res["bbox_video"], (FRAMES, H, W, 3))
            if not (isinstance(res["miou"], float) and 0.0 <= res["miou"] <= 1.0):
                fail(f"teaser miou {res['miou']}")
            sums.append(float(np.asarray(res["video"], np.float64).sum()))

        pipes = []

        def checked_pipeline(models):
            pipes.append(CheckedPipeline(eval_overall.make_pipeline(models), "teaser request",
                                         eval_expected_launches(overall), check))
            return pipes[-1]

        _launch.reset_launch_counts()
        t0 = time.perf_counter()
        with patched(draw_teaser, make_pipeline=checked_pipeline, NUM_SEEDS=TEASER_SEEDS):
            records = draw_teaser.main(cfg)
        secs = time.perf_counter() - t0
        counts = dict(_launch.LAUNCHES)
        if len(records) != 1 or len(records[0]["requests"]) != TEASER_SEEDS:
            fail(f"the teaser tool answered {records}")
        if len(set(sums)) != TEASER_SEEDS:
            fail(f"the seeds' videos are not all different: sums {sums}")
        rec = records[0]
        overlays = range(0, FRAMES, max(FRAMES // 5, 1))
        for req, (peak, _) in zip(rec["requests"], pipes[0].calls):
            print(f"[teaser] request, seed {req['seed']}: {req['seconds']:.3f} s, export (two "
                  f"GIFs, {len(overlays)} overlay PNGs) "
                  f"{req['export_seconds']:.3f} s, miou {req['miou']:.4f}; max_memory_allocated "
                  f"{peak:.2f} GiB; card {card}", flush=True)
        print(f"[teaser] loader: first wait {rec['loader_wait_seconds']:.3f} s ({EVAL_WORKERS} "
              f"spawn workers starting, then the clip), a nuScenes clip's host seconds in one "
              f"process {item_s:.3f} s ({FRAMES} frames: labels, JPEG decode and resize, box "
              f"frames); "
              f"{rec['plots']} ground-truth plots at 1600x900 drawn and written in "
              f"{rec['plot_seconds']:.3f} s", flush=True)

        out = os.path.join(cfg.output_dir, "teaser")
        for s in range(TEASER_SEEDS):
            for name in (f"sample0_seed{s}.gif", f"sample0_seed{s}_bbox.gif"):
                video = load_video(os.path.join(out, name))
                if video.shape[1:] != (H, W, 3):
                    fail(f"{name} has shape {video.shape}")
            for f in overlays:
                if not os.path.exists(os.path.join(out, f"sample0_seed{s}_frame{f}.png")):
                    fail(f"sample0_seed{s}_frame{f}.png was not written")
        plots = [np.asarray(Image.open(os.path.join(out, f"sample0_gt_3d_bbox_frame{f}.png")))
                 for f in range(FRAMES)]
        if any(p.shape != (900, 1600, 3) for p in plots) or not all((p == 255).all()
                                                                    for p in plots):
            fail("the nuScenes ground-truth plots are not white 900x1600 canvases")
        objects = {k: v[0] for k, v in collate_clip_batch([item])["objects"].items()}
        drawn = render_gt_3d_bbox_plots(objects, None, 900, 1600, plot_2d_bbox=True)
        if np.array_equal(drawn[0], drawn[-1]) or (drawn[-1] == 1).all():
            fail("the ground-truth plots with 2D boxes: the last equals the first")
        print(f"[teaser] {TEASER_SEEDS} requests in {secs:.3f} s with the build and the loader; "
              f"files checked: {2 * TEASER_SEEDS} GIFs, {TEASER_SEEDS * len(overlays)} overlays, "
              f"{FRAMES} "
              f"white 1600x900 plots (the same plots with the 2D boxes drawn: the last differs "
              f"from the first); launches {counts}; phase {time.perf_counter() - t_phase:.1f} s",
              flush=True)
        return counts
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


# timed requests of each workload: two leave room in the time limit for [baseline] and [legacy]
BENCH_TIMED_RUNS = 2
# [bench]: the measurement tools, each a process of its own with its time limit in seconds
BENCH_RUNS = (
    ("bench", ("--workload", "overall", "--runs", str(BENCH_TIMED_RUNS)), 400),
    ("bench_train", ("--regime", "controlnet,lora,full", "--accum", "5", "--measure_steps", "1"),
     500),
    ("profile_denoise", ("--steps", "2", "--top", "12"), 300),
)
BENCH_METRICS = ("box2video_25f_512x320_sec_per_clip",
                 "overall_request_25f_512x320_sec_per_request")
# TFLOP of a Box2Video clip at the SVD-XT widths by tools/flops.py, as tests/test_torch_bench.py
# pins it (to 0.1 %)
CLIP_TFLOP, CLIP_TFLOP_TOL = 1308.882, 1e-3
BENCH_DETAIL = ("steps", "runs", "times_s", "min_s", "spread", "init_s", "build_s", "warmup_s",
                "peak_gib", "launches", "tflop_per_clip", "mfu", "temporal_layout", "device")
OVERALL_DETAIL = ("runs", "times_s", "stage1_s", "stage2_s", "select_s", "init_s", "build_s",
                  "peak_gib", "launches", "tflop_per_request", "mfu", "device")
TRAIN_KEYS = ("regime", "attention_impl", "accum", "device", "sec_per_micro_step",
              "sec_per_micro_step_min", "sec_per_micro_step_spread", "sec_per_opt_step", "mfu",
              "tflop_per_micro_step", "trainable_params_m", "loss_first_step", "init_s",
              "peak_gib", "f32_masters", "launches")
PROFILE_KEYS = ("steps", "wall_ms_per_step", "ms_per_step", "calls_per_step", "by_kind", "top",
                "device")


def all_finite(value) -> bool:
    """Every number in ``value`` (nested dicts and lists) is finite; None is not a number."""
    if isinstance(value, dict):
        return all(all_finite(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return all(all_finite(v) for v in value)
    if isinstance(value, (bool, str)):
        return True
    return isinstance(value, (int, float)) and np.isfinite(value)


def check_line(name: str, line: dict, keys, mfu) -> None:
    missing = [k for k in keys if line.get(k) is None]
    if missing or not all_finite({k: line[k] for k in keys}):
        fail(f"{name}: keys missing {missing} or values not finite in {line}")
    if mfu is not None and not 0.0 < mfu < 1.0:
        fail(f"{name}: mfu {mfu}")


def run_tool(name: str, args, timeout: int) -> tuple:
    """``python -m ctrlv_tpu_torch.tools.<name> <args>`` from the repository:
    (its JSON lines, seconds). Fails on a non-zero exit or on the time limit,
    at which the process is killed."""
    cmd = [sys.executable, "-m", f"ctrlv_tpu_torch.tools.{name}", *args]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        fail(f"tools.{name} ran past its {timeout} s")
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-6000:], flush=True)
        print(proc.stderr[-6000:], file=sys.stderr, flush=True)
        fail(f"tools.{name} {' '.join(args)} exited {proc.returncode}")
    return [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")], secs


def phase_bench(card: str, paths: dict) -> None:
    """The measurement tools as a user runs them, each in a process of its own
    while this one holds no model: ``tools.bench --workload overall`` (its
    Box2Video line, median of BENCH_TIMED_RUNS runs, and its overall line), ``tools.bench_train``
    (ControlNet, LoRA and full finetune at accumulation 5, one timed update
    each) and ``tools.profile_denoise`` (2 steps). Every line must hold its
    keys with finite values and an MFU in (0, 1); a clip's launches must be
    [sampler]'s and a request's [overall]'s, and a clip's FLOPs the count the
    CPU test pins."""
    t_phase = time.perf_counter()
    out = {}
    for name, args, timeout in BENCH_RUNS:
        out[name], secs = run_tool(name, args, timeout)
        for line in out[name]:
            print(f"[bench] tools.{name}: {json.dumps(line)}", flush=True)
        print(f"[bench] tools.{name} {' '.join(args)}: {len(out[name])} lines in {secs:.1f} s; "
              f"card {card}", flush=True)

    lines = {line.get("metric"): line for line in out["bench"]}
    clip, request = (lines.get(name) for name in BENCH_METRICS)
    if clip is None or request is None or len(lines) != 2:
        fail(f"tools.bench printed the metrics {sorted(map(str, lines))}")
    for line, detail in ((clip, BENCH_DETAIL), (request, OVERALL_DETAIL)):
        check_line(line["metric"], line, ("metric", "value", "unit"), None)
        check_line(line["metric"], line["detail"], detail, line["detail"]["mfu"])
        if line["value"] != float(np.median(line["detail"]["times_s"])):
            fail(f"{line['metric']}: value {line['value']} is not the median of the runs")
    if not all_finite(clip["vs_baseline"]) or clip["detail"]["runs"] != BENCH_TIMED_RUNS:
        fail(f"the Box2Video line: vs_baseline {clip['vs_baseline']}, runs "
             f"{clip['detail']['runs']}")
    check_launches("tools.bench's Box2Video clip", clip["detail"]["launches"], paths["box2video"])
    check_launches("tools.bench's overall request", request["detail"]["launches"],
                   paths["overall"])
    tflop = clip["detail"]["tflop_per_clip"]
    if abs(tflop - CLIP_TFLOP) > CLIP_TFLOP_TOL * CLIP_TFLOP:
        fail(f"tools.bench counts {tflop} TFLOP a clip, the test pins {CLIP_TFLOP}")

    regimes = [line.get("regime") for line in out["bench_train"]]
    if regimes != ["controlnet", "lora", "full"]:
        fail(f"tools.bench_train printed the regimes {regimes}")
    for line in out["bench_train"]:
        if "error" in line:
            fail(f"tools.bench_train {line['regime']}: {line['error']}")
        check_line(f"tools.bench_train {line['regime']}", line, TRAIN_KEYS, line["mfu"])
        if line["accum"] != 5 or len(line["micro_steps_s"]) != 5:
            fail(f"tools.bench_train {line['regime']}: accum {line['accum']}, "
                 f"{len(line['micro_steps_s'])} timed micro-steps")

    if len(out["profile_denoise"]) != 1:
        fail(f"tools.profile_denoise printed {len(out['profile_denoise'])} JSON lines")
    prof = out["profile_denoise"][0]
    check_line("tools.profile_denoise", prof, PROFILE_KEYS, None)
    if prof["clock"] != "cuda" or not prof["ms_per_step"] > 0 or not prof["top"]:
        fail(f"tools.profile_denoise read no device time: {prof['clock']}, {prof['ms_per_step']}")
    print(f"[bench] checks passed: keys, finite values, mfu in (0, 1), launches against "
          f"[sampler] and [overall], {tflop:.3f} TFLOP a clip (pinned {CLIP_TFLOP}); phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


@torch.no_grad()
def profile_step(models, card: str, out_dir: str) -> None:
    """A reading, not a check: the device time of one ControlNet+UNet step by
    kind of kernel and by kernel (``tools.profile_denoise``), with K7 off and
    on in turns (off, on, on, off; K6 on, its default), then K6 off and on the
    same way (K7 off); the tables by kernel go to
    ``out_dir``/step_profile_{k7,k6}_{off,on}.txt."""
    step, _, _ = make_step(models)
    bench.set_temporal_layout((models["ctrl"], models["unet"]), "frames_major")
    step_device_ms = {}
    os.makedirs(out_dir, exist_ok=True)
    for variant in ("K7 off", "K7 on", "K7 on", "K7 off", "K6 off", "K6 on", "K6 on", "K6 off"):
        resblock.set_fused_resblock(variant == "K7 on")
        if variant.startswith("K6"):
            geglu_ff.set_fused_geglu_ff(variant == "K6 on")
        try:
            ms = cuda_time_ms(step, reps=3, warmup=2)
            table, prof = profile_denoise.profile_steps(step, 1, torch.device(DEVICE))
        finally:
            resblock.set_fused_resblock(False)
            geglu_ff.set_fused_geglu_ff(True)
        if table["clock"] != "cuda" or table["total_ms"] <= 0:
            fail("the profiler recorded no device time")
        step_device_ms.setdefault(variant, []).append(table["total_ms"])
        print(f"[profile] one step, all kernels, frames-major, {variant}: {ms:.1f} ms by CUDA "
              f"events; {table['calls']:.0f} device kernels, {table['total_ms']:.1f} ms of "
              f"device time; card {card}")
        profile_denoise.print_table(table, top=12, tag="[profile] ")
        name = f"step_profile_{variant.split()[0].lower()}_{variant.split()[1]}.txt"
        with open(os.path.join(out_dir, name), "w") as fh:
            fh.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=80,
                                               max_name_column_width=90))
    print("[profile] device ms a step: " + "; ".join(
        f"{v} {', '.join(f'{x:.1f}' for x in xs)}" for v, xs in step_device_ms.items()), flush=True)


# [baseline]: the AR bbox baseline's two commands at the default BaselineConfig
BASELINE_STEPS, BASELINE_SAMPLES = 40, 4
# the card's loss of a fixed batch against the CPU's, both in IEEE f32, relative
BASELINE_LOSS_TOL = 1e-4


def phase_baseline(models, card: str) -> dict:
    """The AR bbox baseline as a user runs it, at the default BaselineConfig
    (batch 2, 25 timesteps x 15 agents, hidden 256, 2 + 4 layers, 8 heads) on
    the synthetic dataset at 512x320, in a working directory of its own:
    ``tools.train_bbox_baseline`` for BASELINE_STEPS steps (its checkpoint
    written at the end), then ``tools.eval_bbox_baseline`` on BASELINE_SAMPLES
    clips from that checkpoint (rollout, render, score, GIF). Checks: finite
    losses, the checkpoint restored bit for bit, every rollout of 25 frames
    with its GIF, the scores in [0, 1], and the card's loss of one fixed batch
    against the CPU's in IEEE f32. Then the baseline's ``ImageEncoder`` once
    over the VAE and CLIP of ``models`` on a 512x320 frame: its K4 and K5
    launches those of one VAE encode and one CLIP forward. The model itself
    runs in f32 and reaches no kernel."""
    from ctrlv_tpu_torch.utils.video_io import load_video

    cfg = BaselineConfig(dataset="synthetic", device=DEVICE)
    os.makedirs(BUILD_DIR, exist_ok=True)
    work, cwd = tempfile.mkdtemp(prefix="baseline_", dir=BUILD_DIR), os.getcwd()
    history, evals = [], []
    try:
        os.chdir(work)
        _launch.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = train_bbox_baseline.main(cfg=cfg, max_steps=BASELINE_STEPS, history=history)
        train_s = time.perf_counter() - t0
        train_peak = torch.cuda.max_memory_allocated() / 2**30
        counts = dict(_launch.LAUNCHES)
        losses = [h["loss"] for h in history]
        if len(history) != BASELINE_STEPS or not np.all(np.isfinite(losses)):
            fail(f"[baseline] training: {len(history)} steps, losses {losses}")
        step_s = np.asarray([h["seconds"] for h in history[1:]])  # the first builds the graph
        ckpt_dir = os.path.join(work, train_bbox_baseline.CHECKPOINT_DIR)
        state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        manager = CheckpointManager(os.path.join(work, "timed_save"))
        t0 = time.perf_counter()
        manager.save(BASELINE_STEPS, model.state_dict(), wait=True)
        save_s = time.perf_counter() - t0
        # a model of another seed, so that the restore has values to change
        fresh = train_bbox_baseline.build_model(dataclasses.replace(cfg, seed=1),
                                                torch.device(DEVICE))
        t0 = time.perf_counter()
        restored = CheckpointManager(ckpt_dir).restore(template=fresh.state_dict())
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        same = sum(torch.equal(restored[k], v) for k, v in state.items())
        if same != len(state) or restored.keys() != state.keys():
            fail(f"[baseline] the checkpoint restored {same} of {len(state)} tensors bit for bit")
        print(f"[baseline] tools.train_bbox_baseline: {BASELINE_STEPS} steps in {train_s:.3f} s, "
              f"s/step median {np.median(step_s):.4f} (min {step_s.min():.4f}, max "
              f"{step_s.max():.4f}, spread {100 * np.ptp(step_s) / np.median(step_s):.1f} %, "
              f"first step {history[0]['seconds']:.3f} s), loss first {losses[0]:.4f} last "
              f"{losses[-1]:.4f}; checkpoint {dir_gb(ckpt_dir) * 1e3:.3f} MB, a save "
              f"{save_s:.3f} s, a restore {restore_s:.3f} s ({same} tensors bit-equal); "
              f"max_memory_allocated {train_peak:.3f} GiB; launches {counts}; card {card}",
              flush=True)

        # the card's loss of one fixed batch against the CPU's, both in IEEE f32
        ds, loader = get_dataloader(cfg.data_root, "synthetic", if_train=False, batch_size=2,
                                    clip_length=cfg.num_timesteps, shuffle=False)
        objects = next(iter(loader))["objects"]
        size = (ds.orig_W, ds.orig_H)
        cpu_model = copy.deepcopy(model).cpu()
        with torch.no_grad(), ieee_f32():
            card_loss = train_bbox_baseline.loss_fn(
                cfg, model, process_data(cfg, objects, size, DEVICE)).item()
            cpu_loss = train_bbox_baseline.loss_fn(
                cfg, cpu_model, process_data(cfg, objects, size, "cpu")).item()
        rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
        print(f"[baseline] a fixed batch's loss in IEEE f32: card {card_loss:.7f}, CPU "
              f"{cpu_loss:.7f}, relative {rel:.2e} (tol {BASELINE_LOSS_TOL})", flush=True)
        if not rel <= BASELINE_LOSS_TOL:
            fail(f"[baseline] the card's loss {card_loss} against the CPU's {cpu_loss}")
        del model, cpu_model, fresh

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        summary = eval_bbox_baseline.main(cfg=cfg, num_samples=BASELINE_SAMPLES, history=evals)
        eval_s = time.perf_counter() - t0
        eval_peak = torch.cuda.max_memory_allocated() / 2**30
        out_dir = os.path.join(work, eval_bbox_baseline.OUT_DIR)
        gifs = sorted(os.listdir(out_dir))
        if gifs != [f"rollout_{i}.gif" for i in range(BASELINE_SAMPLES)] or len(
                evals) != BASELINE_SAMPLES:
            fail(f"[baseline] eval wrote {gifs}, {len(evals)} samples")
        frames = [load_video(os.path.join(out_dir, g)).shape for g in gifs]
        for e, shape in zip(evals, frames):
            # a GIF merges a frame into the one before where they are equal
            if e["frames"] != FRAMES or not 1 <= shape[0] <= FRAMES or shape[1:] != (
                    cfg.train_H, cfg.train_W, 3):
                fail(f"[baseline] a rollout of {e['frames']} frames, its GIF {shape}")
        if set(summary) != set(evals[0]) - {"rollout_s", "render_s", "export_s", "frames"} or not all(
                0.0 <= v <= 1.0 for v in summary.values()):
            fail(f"[baseline] summary {summary}")
        for i, e in enumerate(evals):
            print(f"[baseline] tools.eval_bbox_baseline clip {i}: rollout {e['rollout_s']:.3f} s "
                  f"({cfg.num_timesteps - cfg.initial_frames_condition_num} decoder passes), "
                  f"render {e['render_s']:.3f} s, export {e['export_s']:.3f} s, GIF "
                  f"{frames[i][0]} frames, miou {e['miou']:.4f}", flush=True)
        print(f"[baseline] eval: {BASELINE_SAMPLES} clips in {eval_s:.3f} s, summary "
              f"{json.dumps(summary)}; max_memory_allocated {eval_peak:.3f} GiB; card {card}",
              flush=True)
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    counts = dict(_launch.LAUNCHES)  # train and eval: the model reaches no kernel

    # the image-context encoder over the models this script built
    enc = ImageEncoder(cfg, models["vae"], models["clip"])
    frame = synthetic_request(3)[0]  # (1, 320, 512, 3) in [-1, 1]
    before = dict(_launch.LAUNCHES)
    tokens = enc(frame.to(DEVICE, torch.bfloat16))
    torch.cuda.synchronize()
    got = {k: _launch.LAUNCHES[k] - before[k] for k in before}
    want = expected_launches({"vae": models["vae"], "clip": models["clip"]},
                             {"enc": 1, "clip": 1}, {})
    check_launches("[baseline] the ImageEncoder", got, want)
    if tokens.shape != (1, 33, cfg.hidden_dim) or not bool(torch.isfinite(tokens).all()):
        fail(f"[baseline] ImageEncoder tokens {tuple(tokens.shape)}")
    ms = cuda_time_ms(lambda: enc(frame.to(DEVICE, torch.bfloat16)), reps=5, warmup=1)
    print(f"[baseline] ImageEncoder on a 512x320 frame: tokens {tuple(tokens.shape)}, "
          f"{ms:.3f} ms, launches K4 {got['group_norm']} K5 {got['layer_norm']} (a VAE encode "
          f"and a CLIP forward); card {card}", flush=True)
    for k in counts:
        counts[k] += got[k]
    return counts


# [legacy]: the legacy models at their published widths, seeded random bf16 weights
LEGACY_SEEDS = dict(unet2d=31, object_net=32, bbox_unet=33, layout_net=34)
LEGACY_TURNS = 5
LAYOUT_SEED_FRAMES, LAYOUT_STEPS = 3, 22


def legacy_case(name: str, fn, card: str, expect: dict, tol: float = STEP_TOL) -> dict:
    """One model's forward ``fn``: launches (against ``expect``, the routed
    sites), all kernels against ``plain_kernels()`` in relative L2, ms a
    forward (median of LEGACY_TURNS turns of each, in turns), peak GiB."""
    torch.cuda.reset_peak_memory_stats()
    before = dict(_launch.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    got = {k: _launch.LAUNCHES[k] - before[k] for k in before}
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_launches(f"[legacy] {name}", got, expect)
    with _launch.plain_kernels():
        ref = fn()
    rel = rel_l2(out.float().cpu(), ref.float().cpu())
    if not bool(torch.isfinite(out).all()) or not rel <= tol:
        fail(f"[legacy] {name}: finite {bool(torch.isfinite(out).all())}, relative L2 against "
             f"all plain {rel}")
    ms, plain_ms = [], []
    for variant in ("on", "plain", "plain", "on") * 2:
        ctx = _launch.plain_kernels() if variant == "plain" else contextlib.nullcontext()
        with ctx:
            (ms if variant == "on" else plain_ms).append(
                cuda_time_ms(fn, reps=LEGACY_TURNS, warmup=1))
    print(f"[legacy] {name}: output {tuple(out.shape)}, relative L2 against all plain {rel:.2e} "
          f"(tol {tol}); ms a call, kernels {np.median(ms):.3f} (turns "
          f"{', '.join(f'{x:.3f}' for x in ms)}), all plain {np.median(plain_ms):.3f}; "
          f"launches {({k: v for k, v in got.items() if v})}; max_memory_allocated {peak:.3f} GiB; "
          f"card {card}", flush=True)
    return got


@torch.no_grad()
def phase_legacy(card: str) -> dict:
    """The legacy models at their published widths with seeded random bf16
    weights, each driven once for the launch counts, then held against
    ``plain_kernels()`` and timed: the UNet2D with both object hooks at SD1.x
    width (batch 2, 64x64 latents, 77 text tokens of 768, 16 object tokens
    from KittiObjectNet(out_dim=768, mid_dim=2048) over a collated synthetic
    objects batch; K4, K5 and K6 at each routed site); ``encode_bbox_frame``
    of the bbox-cond UNet-ST at SVD-XT's config (25 frames, 8 layers, width
    2500, a (1, 4, 40, 64) latent; K4 at its GroupNorm of 4 groups, the rest
    plain by the gates), which the encoded objects must not move; LayoutNet's
    ``generate_step`` at GPT-2 base width (12 x 768, 1024 + 1024 channels, 3
    seed frames, 22 steps) in f32, which reaches no kernel."""
    def build(make, seed, dtype=torch.bfloat16):
        with torch.device(DEVICE):
            m = make()
        bench.init_random_(m, seed)
        return m.to(dtype).eval().requires_grad_(False)

    gen = torch.Generator(device=DEVICE).manual_seed(30)
    _, loader = get_dataloader(".", "synthetic", if_train=False, batch_size=2,
                               clip_length=FRAMES, shuffle=False)
    objects = {k: v.to(DEVICE) for k, v in next(iter(loader))["objects"].items()}
    object_net = build(lambda: KittiObjectNet(out_dim=768, mid_dim=2048), LEGACY_SEEDS["object_net"])
    totals = dict.fromkeys(_launch.LAUNCHES, 0)
    before = dict(_launch.LAUNCHES)
    clip_tokens = object_net(objects)  # (2, 25, 30, 768)
    object_embs = object_net({k: v[:, 0] for k, v in objects.items()})[:, :16]  # (2, 16, 768)
    if any(_launch.LAUNCHES[k] != before[k] for k in before) or object_embs.shape != (2, 16, 768):
        fail(f"[legacy] KittiObjectNet: {tuple(object_embs.shape)}, launched kernels")

    unet = build(lambda: UNet2DConditionModel(UNet2DConfig(
        addition_embed_type="object", encoder_hid_dim_type="text_object_proj")),
        LEGACY_SEEDS["unet2d"])
    n_params = sum(p.numel() for p in unet.parameters())
    sample = torch.randn((2, 64, 64, 4), generator=gen, device=DEVICE, dtype=torch.bfloat16)
    text = torch.randn((2, 77, 768), generator=gen, device=DEVICE, dtype=torch.bfloat16)
    t = torch.tensor(500.0, device=DEVICE)
    expect = dict.fromkeys(_launch.LAUNCHES, 0)
    expect.update(group_norm=count_modules(unet, layers.GroupNorm),
                  layer_norm=count_modules(unet, layers.LayerNorm),
                  geglu_ff=count_routed_ff(unet))
    with launches_by_shape("legacy_unet2d", [unet]):
        unet(sample, t, text, object_embs)
    got = legacy_case(f"UNet2D, SD1.x width ({n_params / 1e9:.3f} B parameters), batch 2 at "
                      f"64x64", lambda: unet(sample, t, text, object_embs), card, expect)
    moved = rel_l2(unet(sample, t, text, object_embs + 1.0).float().cpu(),
                   unet(sample, t, text, object_embs).float().cpu())
    if not moved > 1e-3:
        fail(f"[legacy] the UNet2D's object tokens moved its output by {moved}")
    print(f"[legacy] UNet2D: object tokens + 1 move the output by {moved:.3e} relative L2; "
          f"routed sites: {expect['group_norm']} GroupNorms, {expect['layer_norm']} LayerNorms, "
          f"{expect['geglu_ff']} feed-forwards at C = 320 and 640", flush=True)
    for k in totals:
        totals[k] += got[k]
    del unet
    torch.cuda.empty_cache()

    bbox_unet = build(lambda: UNetSpatioTemporalConditionModelWithBBoxCond(
        UNET_CONFIG, num_frames=FRAMES, num_bbox_attn_layers=8), LEGACY_SEEDS["bbox_unet"])
    latent = torch.randn((1, 4, H // 8, W // 8), generator=gen, device=DEVICE,
                         dtype=torch.bfloat16)
    encoded = clip_tokens[:1]
    expect = dict.fromkeys(_launch.LAUNCHES, 0)
    expect["group_norm"] = 1  # its GroupNorm(4); LayerNorm and FF at 2500 fail their gates
    got = legacy_case("encode_bbox_frame of the bbox-cond UNet-ST (SVD-XT, 8 layers, width 2500)",
                      lambda: bbox_unet.encode_bbox_frame(latent, encoded), card, expect)
    out = bbox_unet.encode_bbox_frame(latent, encoded)
    if out.shape != (1, FRAMES, 4, H // 8, W // 8) or not (
            torch.equal(out, bbox_unet.encode_bbox_frame(latent, encoded + 1.0))
            and torch.equal(out, bbox_unet.encode_bbox_frame(latent, None))):
        fail("[legacy] encode_bbox_frame: its shape, or the encoded objects moved it")
    print(f"[legacy] encode_bbox_frame: {tuple(out.shape)}; the encoded objects do not move it "
          f"(bit-equal with objects + 1 and with none)", flush=True)
    for k in totals:
        totals[k] += got[k]
    del bbox_unet
    torch.cuda.empty_cache()

    cfg = LayoutNetConfig()
    layout_net = build(lambda: LayoutNet(cfg), LEGACY_SEEDS["layout_net"], torch.float32)
    seed_layouts = torch.randn((2, LAYOUT_SEED_FRAMES, cfg.n_layout), generator=gen,
                               device=DEVICE)
    cond = torch.randn((2, cfg.n_cond), generator=gen, device=DEVICE)
    got = legacy_case(f"LayoutNet generate_step (GPT-2 base, f32, {LAYOUT_STEPS} steps)",
                      lambda: generate_step(layout_net, seed_layouts, cond, LAYOUT_STEPS), card,
                      dict.fromkeys(_launch.LAUNCHES, 0))
    for k in totals:
        totals[k] += got[k]
    del layout_net, object_net
    torch.cuda.empty_cache()
    return totals


PHASE_SECONDS: dict = {}  # wall seconds a phase, printed with [done]


def timed_phase(name: str, fn, *args):
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_SECONDS[name] = time.perf_counter() - t0


def main() -> None:
    t_start = time.perf_counter()
    card = phase_device()
    timed_phase("build", phase_build)
    if sys.argv[1:2] == ["--profile"] and len(sys.argv) <= 3:
        profile_step(build_models(), card, sys.argv[2] if len(sys.argv) == 3 else "output")
        return
    if sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]}")
    kernels = timed_phase("kernels", phase_kernels)
    timed_phase("grads", phase_grads)
    timed_phase("small", phase_small_reference)
    models = build_models()
    timed_phase("step", phase_step, models)
    paths = {"box2video": timed_phase("sampler", phase_sampler, models, card),
             "overall": timed_phase("overall", phase_overall, models, card)}
    del models["unet1"]  # the stage-1 UNet is not trained
    torch.cuda.empty_cache()
    paths["train"] = timed_phase("train", phase_train, models, card)
    paths["dist"] = timed_phase("dist", phase_dist, models, card)
    del models["ctrl"]
    torch.cuda.empty_cache()
    paths["train_svd"] = timed_phase("train_svd", phase_train_svd, models, card)
    paths["baseline"] = timed_phase("baseline", phase_baseline, models, card)
    del models
    torch.cuda.empty_cache()
    paths["legacy"] = timed_phase("legacy", phase_legacy, card)
    torch.cuda.empty_cache()
    # the tools' own processes: this one holds no model now
    timed_phase("bench", phase_bench, card, paths)
    # one seeded bf16 checkpoint, written by [eval], for the four command phases:
    # the card's machine charges every byte written to its disk against a limit
    os.makedirs(BUILD_DIR, exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="checkpoint_", dir=BUILD_DIR)
    try:
        paths["eval"] = timed_phase("eval", phase_eval, card, paths["overall"], ckpt)
        paths["train_cli"] = timed_phase("train_cli", phase_train_cli, card, paths["train"], ckpt)
        paths.update(timed_phase("eval_metrics", phase_eval_metrics, card, ckpt))
        paths["teaser"] = timed_phase("teaser", phase_teaser, card, paths["overall"], ckpt)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)

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
        if res["device_ms"]:  # K2-K5: the device time apart from the host's
            rows[-1].update(device_ms=float(np.mean(res["device_ms"])),
                            library_device_ms=float(np.mean(res["library_device_ms"])))
        # K1-K6 and K8 belong to the overall path, and all of them but K3 to the
        # Box2Video, eval, training, eval-metric and teaser paths ("seq" layout);
        # K7 to stage 1's training.
        on = {"box2video": kind not in ("small_mha_fm", "resblock"),
              "overall": kind != "resblock",
              "eval": kind not in ("small_mha_fm", "resblock"),
              "train": kind not in ("small_mha_fm", "resblock"),
              "dist": kind not in ("small_mha_fm", "resblock"),
              "train_svd": kind != "small_mha_fm",
              "train_cli": kind not in ("small_mha_fm", "resblock"),
              "eval_bbox": kind not in ("small_mha_fm", "resblock"),
              "eval_gen": kind not in ("small_mha_fm", "resblock"),
              "teaser": kind not in ("small_mha_fm", "resblock"),
              # the baseline's ImageEncoder (VAE encoder, CLIP) and the legacy models:
              # the norms, and K6 at the UNet2D's C = 320 and 640; attention heads of
              # 40-160 (UNet2D), 100 (bbox attention) and 80 (CLIP) take the plain path
              "baseline": kind in ("group_norm", "layer_norm"),
              "legacy": kind in ("group_norm", "layer_norm", "geglu_ff")}
        if any((paths[name][kind] > 0) != due for name, due in on.items()):
            fail(f"{kind} was not launched on its paths: {rows[-1]['launches_by_path']}")
    print_launches_by_shape()
    print(f"[done] {time.perf_counter() - t_start:.1f} s; by phase (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in PHASE_SECONDS.items()))
    print(card)  # name, power limit
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
