"""The trainers' f32 master weights and the ControlNet trainer, on the card.

These tests need an NVIDIA GPU and skip without one. On the card, from the
repository root (``--noconftest``: tests/conftest.py configures JAX, which a
GPU host of the port need not have; this file imports only torch and the
port):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_trainers.py

- ``MasterWeights`` over bf16 tensors on the card against the same optimizer
  on f32 copies of the masters: the same f32 arithmetic on the same device,
  so equal to the bit; each bf16 tensor its master rounded.
- The ControlNet trainer at the tiny config without ``--device`` (the card),
  then resumed from its latest checkpoint with the state equal to the saved
  one bit for bit.
"""

import pytest
import torch

from ctrlv_tpu_torch.tools import train_video_controlnet
from ctrlv_tpu_torch.tools.common import train_state_tree
from ctrlv_tpu_torch.train import CheckpointManager, MasterWeights, MultiSteps, make_optimizer
from ctrlv_tpu_torch.utils.config import parse_args

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(got, want):
    if isinstance(want, torch.Tensor):
        return got.dtype == want.dtype and torch.equal(got.cpu(), want.cpu())
    if isinstance(want, dict):
        return sorted(got) == sorted(want) and all(_same(got[k], want[k]) for k in want)
    return got == want


def test_master_weights_on_the_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    shapes = {"a.weight": (320, 640), "a.bias": (640,), "b.weight": (1280, 320, 3, 3)}
    start = {k: 0.03 * torch.randn(s, generator=gen, device=cuda) for k, s in shapes.items()}
    module = {k: v.bfloat16() for k, v in start.items()}
    plain = {k: v.clone() for k, v in start.items()}
    kw = dict(learning_rate=1e-5, mu_dtype="bfloat16")
    tx = MasterWeights(MultiSteps(make_optimizer(**kw), 2),
                       start={k: v.clone() for k, v in start.items()})
    plain_tx = MultiSteps(make_optimizer(**kw), 2)
    state, plain_state = tx.init(module), plain_tx.init(plain)
    for _ in range(8):
        grads = {k: torch.randn(s, generator=gen, device=cuda).bfloat16()
                 for k, s in shapes.items()}
        state = tx.update(grads, state, module)
        plain_state = plain_tx.update({k: g.float() for k, g in grads.items()}, plain_state, plain)
    for k in shapes:
        assert torch.equal(state["master"][k], plain[k]), k
        assert torch.equal(module[k], plain[k].bfloat16()), k
        assert not torch.equal(module[k], start[k].bfloat16()), k  # it moved


def test_controlnet_trainer_on_the_card_with_resume(cuda, tmp_path):
    args = ["--dataset_name", "synthetic", "--clip_length", "5", "--train_H", "64",
            "--train_W", "64", "--num_demo_samples", "1", "--num_inference_steps", "2",
            "--decode_chunk_size", "5", "--checkpointing_steps", "2", "--validation_steps", "2",
            "--gradient_accumulation_steps", "2", "--output_dir", str(tmp_path)]
    state = train_video_controlnet.main(parse_args(args + ["--max_train_steps", "3"]))
    assert state.step == 3 and all(p.is_cuda for p in state.params.values())
    saved = CheckpointManager(str(tmp_path / "checkpoints")).restore()
    assert saved["step"] == 3
    again = train_video_controlnet.main(parse_args(
        args + ["--max_train_steps", "3", "--resume_from_checkpoint", "latest"]))
    assert _same(train_state_tree(again), saved) and _same(train_state_tree(state), saved)
    for k, p in again.params.items():
        assert torch.equal(p, again.opt_state["master"][k].bfloat16()), k
    more = train_video_controlnet.main(parse_args(
        args + ["--max_train_steps", "4", "--resume_from_checkpoint", "latest"]))
    assert more.step == 4 and more.opt_state["inner"]["gradient_step"] == 2
