"""The port's three trainers end to end on the CPU, at the tiny configs.

``python -m ctrlv_tpu_torch.tools.{train_video_controlnet,train_video_diffusion,
train_vae_finetuning}`` through their ``main`` and command line, on synthetic
clips of 5 frames (the ControlNet and VAE trainers at 64x64; the four
stage-1 regimes at 32x32 to keep the file within its time): the checkpoint
directories rotated at ``--checkpoints_total_limit``, ``logs/metrics.jsonl``,
the media tree of a validation, the f32 export loaded back strictly and equal
to the masters bit for bit, and resume from ``latest`` with the state equal
to the saved one bit for bit. The VAE trainer never resumes and exports
nothing, as the JAX tool.
"""

import json
import os

import pytest
import torch

from ctrlv_tpu_torch.tools import (
    train_vae_finetuning,
    train_video_controlnet,
    train_video_diffusion,
)
from ctrlv_tpu_torch.tools.common import build_models, train_state_tree
from ctrlv_tpu_torch.train import CheckpointManager, load_hf_component
from ctrlv_tpu_torch.utils.config import Config, parse_args
from ctrlv_tpu_torch.utils.safetensors_io import load_file
from ctrlv_tpu_torch.utils.video_io import load_video

torch.set_num_threads(1)


def _args(out, hw, *extra):
    return parse_args([
        "--dataset_name", "synthetic", "--device", "cpu", "--clip_length", "5",
        "--train_H", str(hw), "--train_W", str(hw), "--num_demo_samples", "1",
        "--num_inference_steps", "2", "--decode_chunk_size", "5", "--seed", "3",
        "--checkpointing_steps", "1", "--checkpoints_total_limit", "2", "--validation_steps", "2",
        "--output_dir", str(out), *map(str, extra)])


def _assert_same(got, want, path=""):
    """Two trees equal to the bit: tensors (dtype too), dicts, lists, scalars."""
    if isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got.cpu(), want.cpu()), path
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{path}/{i}")
    else:
        assert got == want, path


def _metrics(out):
    with open(os.path.join(out, "logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _checkpoints(out):
    return sorted(os.listdir(os.path.join(out, "checkpoints")))


def _media(out, step, names, hw):
    step_dir = os.path.join(out, "media", "videos", f"step_{step}")
    assert sorted(os.listdir(step_dir)) == sorted(f"{n}_0.gif" for n in names)
    for n in names:
        assert load_video(os.path.join(step_dir, f"{n}_0.gif")).shape[1:] == (hw, hw, 3), n


def _rounded(state):
    """Each module tensor is its f32 master rounded to bf16."""
    for k, p in state.params.items():
        assert p.dtype == torch.bfloat16, k
        assert torch.equal(p, state.opt_state["master"][k].bfloat16()), k


def test_controlnet_trainer(tmp_path):
    out = tmp_path / "cn"
    state = train_video_controlnet.main(_args(out, 64, "--gradient_accumulation_steps", 2,
                                              "--max_train_steps", 3))
    assert state.step == 3 and state.opt_state["inner"]["mini_step"] == 1
    _rounded(state)
    assert _checkpoints(out) == ["checkpoint-2", "checkpoint-3"]
    assert [(m["step"], sorted(m)) for m in _metrics(out)] == [
        (s, ["grad_norm", "step", "train_loss", "wall_time"]) for s in (1, 2, 3)]
    _media(out, 2, ("generated_videos", "gt_videos", "gt_bbox_frames"), 64)
    _assert_same(CheckpointManager(str(out / "checkpoints")).restore(3), train_state_tree(state))

    # the export: the masters in f32, loaded strictly into a ControlNet
    exported = load_file(str(out / "pipeline" / "control_net"
                             / "diffusion_pytorch_model.safetensors"))
    for k, m in state.opt_state["master"].items():
        assert exported[k].dtype == torch.float32 and torch.equal(exported[k], m), k
    models = build_models(Config(device="cpu", mixed_precision="no"), tiny=True,
                          with_controlnet=True)
    load_hf_component(str(out / "pipeline" / "control_net"), models["ctrl"], strict=True)
    for k, p in models["ctrl"].named_parameters():
        assert torch.equal(p, state.opt_state["master"][k]), k

    # resume: at the latest step nothing runs, and the state is the saved one
    again = train_video_controlnet.main(_args(out, 64, "--gradient_accumulation_steps", 2,
                                              "--max_train_steps", 3,
                                              "--resume_from_checkpoint", "latest"))
    _assert_same(train_state_tree(again), train_state_tree(state))
    _rounded(again)
    more = train_video_controlnet.main(_args(out, 64, "--gradient_accumulation_steps", 2,
                                             "--resume_from_checkpoint", "latest",
                                             "--max_train_steps", 4))
    assert more.step == 4 and more.opt_state["inner"]["mini_step"] == 0
    assert more.opt_state["inner"]["gradient_step"] == 2
    assert _checkpoints(out) == ["checkpoint-3", "checkpoint-4"]
    assert [m["step"] for m in _metrics(out)] == [1, 2, 3, 4]


@pytest.mark.parametrize("regime", [
    ("plain", ()),  # the full finetune
    ("predict_bbox", ("--predict_bbox", "--backprop_temporal_blocks_start_iter", 0)),
    ("lora", ("--enable_lora",)),
    ("ema", ("--use_ema", "--gradient_accumulation_steps", 2,
             "--backprop_temporal_blocks_start_iter", 1)),
], ids=lambda r: r[0])
def test_stage1_trainer(tmp_path, regime):
    name, extra = regime
    out = tmp_path / name
    args = _args(out, 32, "--max_train_steps", 3, *extra)
    ref = build_models(args, tiny=True)["unet"].state_dict()  # the UNet the run starts from
    state = train_video_diffusion.main(args)
    assert state.step == 3 and _checkpoints(out) == ["checkpoint-2", "checkpoint-3"]
    assert [m["step"] for m in _metrics(out) if "train_loss" in m] == [1, 2, 3]
    names = ("generated_videos", "gt_videos") + (("gt_bbox_frames",) if name == "predict_bbox"
                                                 else ())
    _media(out, 2, names, 32)
    masters = state.opt_state["master"]
    if name == "predict_bbox":  # the bbox predictor's selection metric
        assert [m for m in _metrics(out) if "val_miou" in m][0]["step"] == 2
        assert all("temporal_transformer_blocks" in k for k in masters)
    if name == "lora":
        assert all(k.endswith((".lora_a", ".lora_b")) and m.dtype == torch.float32
                   and m is state.params[k] for k, m in masters.items())
    else:
        _rounded(state)

    # the export: f32, loaded strictly by build_models
    models = build_models(Config(device="cpu", mixed_precision="no",
                                 pretrained_model_name_or_path=str(out / "pipeline")), tiny=True)
    unet = models["unet"].state_dict()
    if name == "lora":  # the adapters merged in f32 into the adapted weights alone
        changed = [k for k, v in unet.items() if not torch.equal(v, ref[k].float())]
        assert changed and all(k.endswith(".weight") and k[:-7] + ".lora_a" in masters
                               for k in changed)
    else:
        for k, v in unet.items():
            assert torch.equal(v, masters[k] if k in masters else ref[k].float()), k
    ema = os.path.join(out, "pipeline_ema")
    assert os.path.isdir(ema) == (name == "ema")
    if name == "ema":
        ema_unet = build_models(Config(device="cpu", mixed_precision="no",
                                       pretrained_model_name_or_path=ema), tiny=True)["unet"]
        saved = CheckpointManager(str(out / "checkpoints")).restore()
        assert saved["ema"]["step"] == 3
        for k, v in saved["ema"]["params"].items():
            assert torch.equal(ema_unet.state_dict()[k], v), k
        # resume: at the latest step nothing runs; state and EMA are the saved ones
        again = train_video_diffusion.main(_args(out, 32, "--max_train_steps", 3,
                                                 "--resume_from_checkpoint", "latest", *extra))
        _assert_same(train_state_tree(again), train_state_tree(state))
        _rounded(again)


def test_vae_trainer_never_resumes(tmp_path):
    out = tmp_path / "vae"
    for _ in range(2):
        state = train_vae_finetuning.main(_args(out, 64, "--max_train_steps", 3,
                                                "--resume_from_checkpoint", "latest"))
        assert state.step == 3
    assert all(k.startswith("decoder.") for k in state.params)
    _rounded(state)
    assert _checkpoints(out) == ["checkpoint-2", "checkpoint-3"]
    steps = [m["step"] for m in _metrics(out)]
    assert steps == [1, 2, 2, 3] * 2  # val_psnr logged at step 2, before its micro-step
    assert all(m["val_psnr"] > 0 for m in _metrics(out) if "val_psnr" in m)
    _media(out, 2, ("generated_videos", "gt_videos"), 64)
    assert not os.path.exists(out / "pipeline")
    _assert_same(CheckpointManager(str(out / "checkpoints")).restore(), train_state_tree(state))
