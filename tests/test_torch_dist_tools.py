"""The port's commands on two ``gloo`` ranks against one rank.

- The ControlNet trainer on ``synthetic`` at a global batch of 2: two ranks
  (a data axis of 2, so ZeRO-1 under ``--optimizer_sharding auto``) write
  the checkpoints one rank writes, before and after ``--resume_from_checkpoint
  latest``; only rank 0 writes.
- ``eval_overall`` with ``--mesh_frame 2``: the one-rank summary.

The ranks are spawned processes that call each command's ``main``
(``tests/torch_dist_cases.py::tool_case``); the one-rank run goes on in the
test's own process while they run.

Tolerance: f32 (``--mixed_precision no``) on the CPU. Checkpoint tensors to
1e-6 absolute, as the data-parallel step in ``tests/test_torch_parallel.py``
(lr 1e-5, the trainer's default); the eval's scores to 1e-6.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import torch

from ctrlv_tpu_torch.parallel.launch import spawn
from ctrlv_tpu_torch.tools import eval_overall, train_video_controlnet
from ctrlv_tpu_torch.train import CheckpointManager
from ctrlv_tpu_torch.utils.config import parse_args
import torch_dist_cases as cases

torch.set_num_threads(1)
RANKS_S = 300  # the spawned ranks' limit: ended and failed after it


def _trainer_args(out, *extra):
    return ["--dataset_name", "synthetic", "--device", "cpu", "--mixed_precision", "no",
            "--clip_length", "3", "--train_H", "32", "--train_W", "32",
            "--train_batch_size", "2", "--gradient_accumulation_steps", "2",
            "--num_demo_samples", "1", "--validation_steps", "0", "--seed", "3",
            "--checkpointing_steps", "2", "--output_dir", str(out), *map(str, extra)]


def _assert_trees_close(got, want, path=""):
    if isinstance(want, torch.Tensor):
        assert got.shape == want.shape and got.dtype == want.dtype, path
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6, msg=lambda m: f"{path}: {m}")
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_close(got[k], want[k], f"{path}/{k}")
    else:
        assert got == want, path


def _beside_two_ranks(tmp_path, args, one_rank):
    """``tool_case(*args)`` on two spawned ranks while ``one_rank()`` runs here."""
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, cases.tool_case, 2, "cpu", args, store_dir=str(tmp_path),
                            timeout=RANKS_S)
        want = one_rank()
        ranks.result()
    return want


def test_controlnet_trainer_on_two_ranks(tmp_path):
    one, two = tmp_path / "one", tmp_path / "two"
    for steps, extra in ((2, ()), (4, ("--resume_from_checkpoint", "latest"))):
        argv = ("--max_train_steps", steps, *extra)
        _beside_two_ranks(tmp_path, ("train_video_controlnet", _trainer_args(two, *argv)),
                          lambda: train_video_controlnet.main(
                              parse_args(_trainer_args(one, *argv))))
        for step in range(2, steps + 1, 2):
            want = CheckpointManager(str(one / "checkpoints")).restore(step)
            got = CheckpointManager(str(two / "checkpoints")).restore(step)
            _assert_trees_close(got, want, f"checkpoint-{step}")
    assert sorted(os.listdir(two / "checkpoints")) == ["checkpoint-2", "checkpoint-4"]
    with open(two / "logs" / "metrics.jsonl") as f:  # rank 0's log alone
        assert [line.count('"step"') for line in f] == [1] * 4


def test_eval_overall_frame_sharded_on_two_ranks(tmp_path):
    argv = ["--dataset_name", "synthetic", "--device", "cpu", "--mixed_precision", "no",
            "--clip_length", "3", "--train_H", "16", "--train_W", "16",
            "--num_inference_steps", "2", "--decode_chunk_size", "3", "--num_demo_samples", "1"]
    out = tmp_path / "two"
    want = _beside_two_ranks(
        tmp_path, ("eval_overall", argv + ["--mesh_frame", "2", "--output_dir", str(out)]),
        lambda: eval_overall.main(parse_args(argv + ["--output_dir", str(tmp_path / "one")])))
    for r in range(2):
        got = torch.load(out / "ranks" / f"rank{r}.pt", weights_only=False)
        assert sorted(got) == sorted(want)
        for k, (mean, std) in want.items():
            assert abs(got[k][0] - mean) <= 1e-6 and abs(got[k][1] - std) <= 1e-6, k
    assert sorted(p for p in os.listdir(out) if p.endswith(".gif")) == [
        "generated_video_0.gif", "predicted_bbox_0.gif"]
