"""The multi-card paths at world 1 over NCCL, on the card.

These tests need an NVIDIA GPU and skip without one. On the card, from the
repository root (``--noconftest``: tests/conftest.py configures JAX, which a
GPU host of the port need not have; this file imports only torch and the
port):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_dist.py

What ``chip_smoke.py [dist]`` checks at full width, at the tiny config: a
process group of one NCCL rank (a ``file://`` rendezvous under the test's
directory), the Box2Video sampler through its ``mesh=`` path and the
ControlNet step through its data-parallel update, each equal to the bit to
the same call without a mesh, with the same kernel launches, while the
collective counters show that the mesh path called ``torch.distributed``;
and the dry-run command with one spawned NCCL rank.
"""

import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from ctrlv_tpu_torch.models import (
    AutoencoderKLTemporalDecoder,
    CLIPVisionConfig,
    CLIPVisionModelWithProjection,
    ControlNetSpatioTemporal,
    UNetSpatioTemporalConditionModel,
    UNetSTConfig,
    VAEConfig,
    controlnet_from_unet,
)
from ctrlv_tpu_torch.ops import _launch
from ctrlv_tpu_torch.parallel import (
    COLLECTIVES,
    make_mesh,
    make_train_mesh,
    reset_collective_counts,
    shard_train_state,
)
from ctrlv_tpu_torch.pipelines import StableVideoControlPipeline
from ctrlv_tpu_torch.train import init_train_state, make_controlnet_train_step, make_optimizer

pytestmark = pytest.mark.cuda
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F, H, W = 5, 64, 64


@pytest.fixture
def nccl(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
                            world_size=1)
    try:
        yield torch.device("cuda", 0)
    finally:
        dist.destroy_process_group()


def _counted(fn):
    torch.cuda.synchronize()
    _launch.reset_launch_counts()
    reset_collective_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(_launch.LAUNCHES), dict(COLLECTIVES)


def _models(device):
    torch.manual_seed(0)
    with device:
        unet = UNetSpatioTemporalConditionModel(UNetSTConfig.tiny())
        ctrl = ControlNetSpatioTemporal(UNetSTConfig.tiny())
        controlnet_from_unet(unet, ctrl)
        vae = AutoencoderKLTemporalDecoder(VAEConfig.tiny())
        clip = CLIPVisionModelWithProjection(CLIPVisionConfig.tiny())
    return [m.to(torch.bfloat16).eval() for m in (unet, ctrl, vae, clip)]


def test_world_one_is_the_run_without_a_mesh(nccl):
    unet, ctrl, vae, clip = _models(nccl)
    image = torch.rand((1, H, W, 3), device=nccl) * 2 - 1
    cond = torch.rand((1, F, H, W, 3), device=nccl) * 2 - 1

    def sample(mesh):
        pipe = StableVideoControlPipeline(unet, ctrl, vae, clip, mesh=mesh)
        return pipe(image, cond, generator=torch.Generator(device=nccl).manual_seed(1),
                    num_frames=F, num_inference_steps=2, decode_chunk_size=F)

    ref, ref_counts, ref_coll = _counted(lambda: sample(None))
    out, counts, coll = _counted(lambda: sample(make_mesh(1, 1)))
    assert torch.equal(out, ref) and counts == ref_counts
    assert not any(ref_coll.values()) and coll["all_gather"] > 0

    start = {k: p.detach().clone() for k, p in ctrl.named_parameters()}

    def micro_step(mesh):
        with torch.no_grad():
            for k, p in ctrl.named_parameters():
                p.copy_(start[k])
        tx = make_optimizer(learning_rate=1e-3, nan_guard_steps=0)
        step = make_controlnet_train_step(unet, ctrl, vae, clip, tx, mesh=mesh)
        state = init_train_state(ctrl.requires_grad_(True), tx)
        if mesh is not None:
            state = shard_train_state(state, mesh, zero1=True)
        state, metrics = step(state, cond, cond, generator=torch.Generator(device=nccl)
                              .manual_seed(2))
        return ({k: float(v) for k, v in metrics.items()},
                {k: p.detach().clone() for k, p in state.params.items()})

    (ref_m, ref_p), ref_counts, ref_coll = _counted(lambda: micro_step(None))
    (met, params), counts, coll = _counted(lambda: micro_step(make_train_mesh(1)))
    assert met == ref_m and counts == ref_counts
    assert all(torch.equal(params[k], ref_p[k]) for k in ref_p)
    assert any(not torch.equal(ref_p[k], start[k]) for k in ref_p)
    assert not any(ref_coll.values()) and coll["all_reduce"] > 0


def test_dryrun_multichip_on_one_nccl_rank(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "ctrlv_tpu_torch.tools.dryrun_multichip", "--nproc", "1",
         "--store_dir", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1].startswith("dryrun_multichip ok: mesh=(1x1)")
