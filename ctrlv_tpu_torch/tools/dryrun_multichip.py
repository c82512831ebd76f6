"""Dry run of the multi-card paths on micro models.

    python -m ctrlv_tpu_torch.tools.dryrun_multichip --nproc 2 --device cpu
    torchrun --nproc_per_node 4 -m ctrlv_tpu_torch.tools.dryrun_multichip

Counterpart of ``__graft_entry__.dryrun_multichip``: over an (n/2, 2) mesh of
n ranks, or (n, 1) for odd n, one data-parallel stage-1 training step (CLIP,
VAE encode, UNet forward and backward, AdamW) on the micro UNet, the tiny
VAE and a one-layer CLIP, on a global batch of 2 per data rank; then one
frame-sharded UNet forward at an odd F = 5 (3 + 2 frames over a frame axis
of 2), gathered and held against the unsharded forward. Rank 0 prints
``dryrun_multichip ok: mesh=(d x f), loss=...``.

Under ``torchrun`` it runs on the ranks it is given; otherwise it spawns
``--nproc`` ranks itself (``parallel.launch.spawn``): ``nccl`` on the cards,
``gloo`` with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from ..models import (
    AutoencoderKLTemporalDecoder,
    CLIPVisionConfig,
    CLIPVisionModelWithProjection,
    UNetSpatioTemporalConditionModel,
    UNetSTConfig,
    VAEConfig,
)
from ..parallel.frames import FrameShard, frame_sharded
from ..parallel.launch import spawn
from ..parallel.mesh import init_from_env, make_mesh, rank, world_size
from ..train import init_train_state, make_optimizer, make_svd_train_step

FRAMES, SHARDED_FRAMES, H, W = 4, 5, 16, 16
# the unsharded forward against the gathered sharded one: the same f32
# arithmetic on the frames each rank holds, but the batched matmuls and
# convolutions see other batch sizes, so their sums may run in another order
FORWARD_TOL = 1e-4


def dryrun(device) -> str:
    """The dry run on the ranks of the running process group (or alone);
    returns rank 0's line."""
    n = world_size()
    n_frame = 2 if n % 2 == 0 and n >= 2 else 1
    mesh = make_mesh(n // n_frame, n_frame)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())

    torch.manual_seed(0)  # the same weights on every rank
    ucfg, vcfg = UNetSTConfig.micro(), VAEConfig.tiny()
    ccfg = dataclasses.replace(CLIPVisionConfig.tiny(), num_hidden_layers=1)
    with device:
        unet = UNetSpatioTemporalConditionModel(ucfg)
        vae = AutoencoderKLTemporalDecoder(vcfg)
        clip = CLIPVisionModelWithProjection(ccfg)

    batch = 2 * mesh.n_data
    gen = torch.Generator(device=device).manual_seed(0)
    clips = torch.rand((batch, FRAMES, H, W, 3), generator=gen, device=device) * 2 - 1
    tx = make_optimizer(learning_rate=1e-5)
    state = init_train_state(unet, tx)
    step = make_svd_train_step(unet, vae, clip, tx, conditioning_dropout_prob=0.1,
                               device=device, mesh=mesh)
    state, metrics = step(state, clips, clips, generator=gen.manual_seed(1))
    loss = float(metrics["loss"])
    if not torch.isfinite(torch.tensor(loss)):
        raise RuntimeError(f"non-finite loss {loss}")

    lh, lw = H // vcfg.spatial_scale, W // vcfg.spatial_scale
    lat = torch.randn((2, SHARDED_FRAMES, lh, lw, ucfg.in_channels), generator=gen,
                      device=device)
    enc = torch.zeros((2, 1, ucfg.cross_attention_dim), device=device)
    tids = torch.tensor([[6.0, 127.0, 0.02]] * 2, device=device)
    shard = FrameShard(mesh, SHARDED_FRAMES)
    with torch.no_grad():
        with frame_sharded(shard):
            local = unet(shard.local_frames(lat), 0.5, enc, tids)
        out = shard.gather(local.flatten(0, 1), 2).unflatten(0, (2, SHARDED_FRAMES))
        ref = unet(lat, 0.5, enc, tids)
    if out.shape != (2, SHARDED_FRAMES, lh, lw, ucfg.out_channels):
        raise RuntimeError(f"sharded forward gave {tuple(out.shape)}")
    err = (out - ref).abs().max().item()
    if not err <= FORWARD_TOL:
        raise RuntimeError(f"sharded forward differs from the unsharded one by {err:.3e}")
    return (f"dryrun_multichip ok: mesh=({mesh.n_data}x{mesh.n_frame}), loss={loss:.4f}, "
            f"frame shards {shard.bounds}, sharded vs unsharded max_abs_err={err:.3e}")


def _rank_main(rank_: int, nproc: int, device: str) -> None:
    line = dryrun(device if device == "cpu" else f"cuda:{rank_}")
    if rank_ == 0:
        print(line, flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nproc", type=int, default=2,
                    help="ranks to spawn where torchrun started none")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--store_dir", default=None,
                    help="directory of the spawned ranks' rendezvous file")
    args = ap.parse_args(argv)
    if init_from_env(args.device):
        line = dryrun(args.device)
        if rank() == 0:
            print(line, flush=True)
        return
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the ranks on the CPU")
    spawn(_rank_main, args.nproc, args.device, (args.device,), store_dir=args.store_dir)


if __name__ == "__main__":
    main()
