"""The trainers' state against the JAX package, on the CPU.

- ``MasterWeights`` over bf16 tensors against optax on the f32 parameters:
  the JAX trainers hold f32 parameters and compute in bf16, so given the same
  (bf16) gradients, upcast, the masters must follow optax's parameters, and
  each bf16 tensor must be its master rounded to nearest even. Tolerance: the
  same f32 arithmetic in another order, 1e-6 relative to each tensor's
  largest element over 20 updates at lr 1e-5 (measured: 0 to a few f32 ulps).
- ``CheckpointManager``: rotation, the latest step, restore to the bit, the
  asynchronous save joined, a failed save raised.
- ``utils/samples.py`` against ``ctrlv_tpu/utils/samples.py`` on one
  synthetic batch from each package's loader; ``Tracker`` against the JAX
  ``Tracker`` (its file I/O needs no jit): the same JSONL keys but
  ``wall_time``, the same GIF frames; ``rand_log_normal`` against the JAX
  formula on the same uniforms.
- Each trainer raises without ``--device`` where there is no card.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.scipy.stats import norm

from ctrlv_tpu.data import get_dataloader as jax_get_dataloader
from ctrlv_tpu.train.observability import Tracker as JaxTracker
from ctrlv_tpu.train.state import make_optimizer as jax_make_optimizer
from ctrlv_tpu.utils import samples as jax_samples
from ctrlv_tpu.utils.config import Config as JaxConfig
from ctrlv_tpu_torch.data import get_dataloader
from ctrlv_tpu_torch.tools import (
    train_vae_finetuning,
    train_video_controlnet,
    train_video_diffusion,
)
from ctrlv_tpu_torch.train import (
    CheckpointManager,
    MasterWeights,
    MultiSteps,
    make_optimizer,
)
from ctrlv_tpu_torch.train.observability import Tracker
from ctrlv_tpu_torch.utils import samples
from ctrlv_tpu_torch.utils.config import Config, parse_args
from ctrlv_tpu_torch.utils.misc import rand_log_normal
from ctrlv_tpu_torch.utils.video_io import load_video

torch.set_num_threads(1)

# name -> (shape, scale): at scale 0.03 a bf16 ulp is 2**-13 or 2**-14, so a
# step of about lr = 1e-5 rounds away, while 20 of them do not
SHAPES = {
    "down.temporal_transformer_blocks.0.proj.weight": ((24, 16), 0.03),
    "down.temporal_transformer_blocks.0.proj.bias": ((24,), 0.003),
    "down.resnets.0.conv1.weight": ((8, 4, 3, 3), 1.0),
    "down.resnets.0.norm1.weight": ((32,), 0.03),
}


def _masters_case(seed=0):
    rng = np.random.default_rng(seed)
    f32 = {k: (scale * rng.standard_normal(shape)).astype(np.float32)
           for k, (shape, scale) in SHAPES.items()}
    mask = {k: ("temporal" in k or "norm" in k) for k in SHAPES}
    # 40 micro-steps of bf16 gradients (what a bf16 backward gives)
    grads = [{k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32)).bfloat16()
              for k, v in f32.items()} for _ in range(40)]
    return f32, mask, grads


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The bf16 spacing at each element of ``x`` (8 significant bits)."""
    _, exponent = torch.frexp(x.bfloat16().float())
    return torch.ldexp(torch.ones_like(x), exponent - 8)


def test_master_weights_follow_optax_on_f32_params():
    f32, mask, grads = _masters_case()
    kw = dict(learning_rate=1e-5, mu_dtype="bfloat16")
    jtx = optax.MultiSteps(jax_make_optimizer(mask=mask, **kw), every_k_schedule=2)
    ref = {k: jnp.asarray(v) for k, v in f32.items()}
    ref_state = jtx.init(ref)
    update = jax.jit(jtx.update)

    start = {k: torch.from_numpy(v) for k, v in f32.items()}
    module = {k: v.bfloat16() for k, v in start.items()}  # what build_models casts
    # f32 on the module's device: the masters are these very tensors
    tx = MasterWeights(MultiSteps(make_optimizer(mask=mask, **kw), 2),
                       start={k: v.clone() for k, v in start.items()})
    state = tx.init(module)
    # the same step on bf16 tensors without masters: the stall this repairs
    bare = {k: v.bfloat16() for k, v in start.items()}
    bare_tx = MultiSteps(make_optimizer(mask=mask, **kw), 2)
    bare_state = bare_tx.init(bare)

    for i, g in enumerate(grads):
        updates, ref_state = update({k: jnp.asarray(v.float().numpy()) for k, v in g.items()},
                                    ref_state, ref)
        ref = optax.apply_updates(ref, updates)
        state = tx.update(g, state, module)
        bare_state = bare_tx.update(g, bare_state, bare)
        if i % 2:
            for k, want in ref.items():
                got, want = state["master"][k].numpy(), np.asarray(want)
                assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), (i, k)
                assert module[k].dtype == torch.bfloat16
                assert torch.equal(module[k], state["master"][k].bfloat16()), (i, k)

    inner = state["inner"]["inner"]["inner"]["inner"]  # MultiSteps, ApplyIfFinite, Masked
    assert inner["count"] == 20 and state["inner"]["gradient_step"] == 20
    name = "down.temporal_transformer_blocks.0.proj.weight"
    assert inner["mu"][name].dtype == torch.bfloat16 and inner["nu"][name].dtype == torch.float32
    moved = bare_moved = 0
    for k, first in start.items():
        # how far each master went from the value its module tensor started at, in bf16 ulps
        dist = (state["master"][k] - first.bfloat16().float()).abs() / _bf16_ulp(first)
        changed = module[k] != first.bfloat16()
        assert bool(changed.any()) == bool((dist > 0.5).any()), k  # a tensor that went far moved
        assert changed[dist > 1].all(), k  # so did each element a whole ulp away
        moved += int(changed.sum())
        bare_moved += int((bare[k] != first.bfloat16()).sum())
        if not mask[k]:
            assert torch.equal(state["master"][k], first) and not changed.any(), k
    # without masters most of these steps round away (measured: 53 elements against 212)
    assert moved >= 2 * bare_moved > 0, (moved, bare_moved)


def test_master_weights_of_f32_tensors_are_the_tensors():
    f32, _, grads = _masters_case(1)
    params = {k: torch.from_numpy(v.copy()) for k, v in f32.items()}
    plain = {k: v.clone() for k, v in params.items()}
    tx = MasterWeights(make_optimizer(learning_rate=1e-3))
    plain_tx = make_optimizer(learning_rate=1e-3)
    state, plain_state = tx.init(params), plain_tx.init(plain)
    assert all(state["master"][k] is params[k] for k in params)
    for g in grads[:3]:
        state = tx.update(g, state, params)
        plain_state = plain_tx.update({k: v.float() for k, v in g.items()}, plain_state, plain)
    for k in params:
        assert torch.equal(params[k], plain[k]), k


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    shared = torch.randn(3, 4, generator=g)
    return {"opt_state": {"master": {"a.weight": shared, "b.bias": torch.randn(5, generator=g)},
                          "inner": {"mini_step": seed, "last_finite": True, "none": None,
                                    "mu": {"a.weight": torch.randn(3, 4, generator=g).bfloat16()},
                                    "list": [1.5, torch.arange(3)]}},
            "params": {"a.weight": shared}, "step": seed}


def _assert_trees_equal(got, want):
    if isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_trees_equal(a, b)
    else:
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize("async_save", [True, False])
def test_checkpoint_manager_rotates_restores_and_joins(tmp_path, async_save):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2, async_save=async_save)
    assert mgr.latest_step() is None and mgr.restore() is None
    trees = {step: _tree(step) for step in (1, 2, 3, 4)}
    for step in trees:
        tree = _tree(step)
        assert mgr.save(step, tree)
        tree["opt_state"]["master"]["b.bias"].fill_(7.0)  # after the save: not in it
    assert not mgr.save(3, _tree(9), wait=True)  # at or below the latest: not saved again
    mgr.wait()
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["checkpoint-3", "checkpoint-4"]
    assert mgr.latest_step() == 4 and mgr.all_steps() == [3, 4]
    _assert_trees_equal(mgr.restore(), trees[4])
    _assert_trees_equal(mgr.restore(3), trees[3])
    got = mgr.restore(3)
    assert got["params"]["a.weight"] is got["opt_state"]["master"]["a.weight"]  # written once

    template = _tree(0)
    out = CheckpointManager(str(tmp_path / "ckpt")).restore(4, template=template)
    _assert_trees_equal(out, trees[4])
    assert out["opt_state"]["master"]["a.weight"] is template["opt_state"]["master"]["a.weight"]
    assert out["params"]["a.weight"] is template["params"]["a.weight"]
    template["opt_state"]["inner"]["mu"]["a.weight"] = torch.zeros(3, 4)  # f32, not bf16
    with pytest.raises(ValueError, match="does not fit"):
        mgr.restore(4, template=template)

    mgr.save(5, {"x": torch.zeros(2, dtype=torch.bool)})  # a dtype the format lacks
    with pytest.raises(RuntimeError, match="checkpoint save failed"):
        mgr.wait()
    assert mgr.latest_step() == 4 and mgr._thread is None
    mgr.close()


def _loader(pkg_loader, batch_size=2, **kw):
    kw = dict(if_train=True, clip_length=3, if_return_bbox_im=True, train_H=16, train_W=24,
              seed=2, **kw)
    return pkg_loader(".", "synthetic", batch_size=batch_size, **kw)[1]


def test_samples_equal_jax(tmp_path):
    ours = _loader(get_dataloader)
    ref = _loader(jax_get_dataloader, prefetch=0)
    got, want = samples.get_n_training_samples(ours, 2), jax_samples.get_n_training_samples(ref, 2)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in ("gt_clip", "gt_clip_np", "image_init", "bbox_img", "bbox_img_np", "bbox_init",
                  "cam_to_img"):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["index"] == b["index"]
        assert len(a["gt_labels"]) == len(b["gt_labels"]) == 3
        for la, lb in zip(a["gt_labels"], b["gt_labels"]):
            for oa, ob in zip(la, lb):
                for k in ob:
                    np.testing.assert_array_equal(np.asarray(oa[k]), np.asarray(ob[k]), err_msg=k)
        for k, v in b["objects_tensors"].items():
            np.testing.assert_array_equal(a["objects_tensors"][k].numpy(), v, err_msg=k)

    one = _loader(get_dataloader, 1, shuffle=False)
    one_ref = _loader(jax_get_dataloader, 1, shuffle=False, prefetch=0)
    with pytest.raises(ValueError, match="batch size 1"):
        next(samples.eval_samples_generator(ours))
    first = next(samples.eval_samples_generator(one, start_index=1))
    first_ref = next(jax_samples.eval_samples_generator(one_ref, start_index=1))
    assert first["index"] == first_ref["index"] == 1
    np.testing.assert_array_equal(first["gt_clip"], first_ref["gt_clip"])

    path = tmp_path / "demo.pkl"
    path.write_bytes(pickle.dumps({"gt_clip_np": first["gt_clip_np"]}))
    demo = list(samples.eval_demo_samples_generator([str(path)]))
    demo_ref = next(jax_samples.eval_demo_samples_generator([str(path)]))
    np.testing.assert_array_equal(demo[0]["gt_clip_np"], demo_ref["gt_clip_np"])


def test_tracker_writes_what_the_jax_tracker_writes(tmp_path):
    frames = np.random.default_rng(0).integers(0, 255, (4, 16, 24, 3), dtype=np.uint8)
    for name, cls, cfg_cls, loss in (("jax", JaxTracker, JaxConfig, np.float32(0.25)),
                                     ("port", Tracker, Config, torch.tensor(0.25))):
        tracker = cls(cfg_cls(output_dir=str(tmp_path / name)))
        tracker.log_scalars(1, {"train_loss": loss, "grad_norm": 2.0})
        tracker.log_scalars(2, {"val_miou": 0.5})
        tracker.log_video(2, "generated_videos_0", frames, fps=5)
        tracker.finish()
    lines = {}
    for name in ("jax", "port"):
        with open(tmp_path / name / "logs" / "metrics.jsonl") as f:
            lines[name] = [json.loads(line) for line in f]
        for rec in lines[name]:
            assert rec.pop("wall_time") >= 0
    assert lines["port"] == lines["jax"] == [
        {"train_loss": 0.25, "grad_norm": 2.0, "step": 1}, {"val_miou": 0.5, "step": 2}]
    gifs = [load_video(str(tmp_path / n / "media" / "videos" / "step_2" / "generated_videos_0.gif"))
            for n in ("jax", "port")]
    np.testing.assert_array_equal(gifs[0], gifs[1])
    assert gifs[1].shape == (4, 16, 24, 3)


def test_rand_log_normal_matches_the_jax_formula():
    gen = torch.Generator().manual_seed(5)
    got = rand_log_normal(gen, (1000,), loc=0.7, scale=1.6)
    u = torch.rand((1000,), generator=torch.Generator().manual_seed(5)).numpy()
    u = u * np.float32(1 - 2e-7) + np.float32(1e-7)
    want = np.asarray(jnp.exp(norm.ppf(jnp.asarray(u)) * 1.6 + 0.7))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert got.dtype == torch.float32 and (got > 0).all()


@pytest.mark.parametrize("tool", [train_video_controlnet, train_video_diffusion,
                                  train_vae_finetuning])
def test_the_trainers_run_on_the_card_unless_told(monkeypatch, tmp_path, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(parse_args(["--dataset_name", "synthetic", "--output_dir", str(tmp_path)]))
    assert not os.listdir(tmp_path)
