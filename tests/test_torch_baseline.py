"""The port's AR bbox baseline against the JAX package's.

- The action vocabulary, ``reshape_data``, ``smooth_gt_leaving_frame``,
  ``normalize_track_ids`` and ``process_data`` on a collated synthetic batch:
  tokens and track ids bit-equal, continuous values within 1e-6.
- ``BboxPredictorLM`` with the same seeded parameters (``convert.py``, strict
  load): the token, coords-token and coords-regression variants (the last
  with the existence head), outputs and loss within 1e-5 relative.
- Three steps of the training tool's update (``tools.train_bbox_baseline``:
  clip, AdamW, warm-up, the decay mask) against the JAX tool's optax chain:
  the decay mask leaf for leaf, losses to 1e-5, parameters to 1e-5 relative L2.
- A rollout with JAX's Gumbel draws injected: the same tokens, boxes to 1e-5.
- ``render`` (native rasterizer) within 0.2 % of the pixels of the JAX
  policy's (XLA rasterizer); ``score`` to 1e-6.
- Both commands end to end on the synthetic dataset at a tiny size with
  ``device=cpu``, from the JAX tool's initial parameters: the printed losses
  and the trained parameters against the JAX tool's, the scores against the
  JAX eval tool's; the checkpoint the port writes restores bit for bit.
- The commands run on the card unless told ``device=cpu``.
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctrlv_tpu.baseline import BaselineConfig as JaxConfig
from ctrlv_tpu.baseline import BboxPredictorLM as JaxLM
from ctrlv_tpu.baseline import BboxPredictorLMPolicy as JaxPolicy
from ctrlv_tpu.baseline import actions as jax_actions
from ctrlv_tpu.baseline import process_data as jax_process_data
from ctrlv_tpu_torch.baseline import (
    BaselineConfig,
    BboxPredictorLM,
    BboxPredictorLMPolicy,
    actions,
    process_data,
)
from ctrlv_tpu_torch.baseline.config import config_from_overrides
from ctrlv_tpu_torch.convert import flax_to_state_dict
from ctrlv_tpu_torch.data import get_dataloader
from ctrlv_tpu_torch.tools import eval_bbox_baseline, train_bbox_baseline
from ctrlv_tpu_torch.train.checkpoints import CheckpointManager
from test_torch_convert import flat, seeded_params
from test_torch_user_tools import _jax_tool

torch.set_num_threads(1)

TINY = dict(train_W=96, train_H=64, dataset="synthetic")
CFG = BaselineConfig.tiny(device="cpu", **TINY)
JCFG = JaxConfig.tiny(**TINY)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _batch(cfg, b=2, seed=0):
    """Random walks of boxes in [0, 1], some agents absent: agent 1 of the
    first clip from t=2 on, the last agent of the second clip throughout (a
    pad agent, every key of its row masked)."""
    rng = np.random.default_rng(seed)
    t, n = cfg.num_timesteps, cfg.max_num_agents
    start = rng.uniform(0.2, 0.6, (b, 1, n, 4))
    bboxes = np.clip(start + np.cumsum(rng.uniform(-0.02, 0.02, (b, t, n, 4)), 1), 0.05, 0.95)
    bboxes[..., 2] = bboxes[..., 0] + 0.1
    bboxes[..., 3] = bboxes[..., 1] + 0.15
    bboxes[0, 2:, 1] = 0.0
    bboxes[1, :, -1] = 0.0
    bboxes = bboxes.astype(np.float32)
    acts = np.asarray(jax_actions.bbox_seq_to_actions(jnp.asarray(bboxes)))
    exist = (bboxes[..., -1:] != 0)
    return dict(bboxes=bboxes, actions=acts, coords=bboxes.copy(),
                type_ids=rng.integers(0, 5, (b, t, n, 1)).astype(np.float32), existence=exist)


def _jax(data):
    return {k: jnp.asarray(v) for k, v in data.items()}


def _port(data):
    return {k: _t(v) for k, v in data.items()}


def _models(cfg, jcfg, seed=3, data=None):
    data = data if data is not None else _batch(cfg)
    jmodel = JaxLM(cfg=jcfg)
    params = seeded_params(jmodel, seed, _jax(data))
    port = BboxPredictorLM(cfg)
    port.load_state_dict(flax_to_state_dict(flat(params)), strict=True)
    return jmodel, params, port.eval(), data


# --- actions and data ------------------------------------------------------

def test_actions_match_jax():
    data = _batch(CFG, seed=1)
    bb = data["bboxes"]
    acts = actions.bbox_seq_to_actions(_t(bb))
    np.testing.assert_allclose(acts.numpy(), data["actions"], atol=1e-6, rtol=0)
    tok = actions.discretize_actions(acts)
    jtok = jax_actions.discretize_actions(jnp.asarray(data["actions"]))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(actions.undiscretize_actions(tok.int()).numpy(),
                               np.asarray(jax_actions.undiscretize_actions(jtok.astype(jnp.int32))),
                               atol=1e-6, rtol=0)
    rebuilt = actions.actions_to_bbox_seq(acts, _t(bb[:, 0]))
    jrebuilt = jax_actions.actions_to_bbox_seq(jnp.asarray(data["actions"]), jnp.asarray(bb[:, 0]))
    np.testing.assert_allclose(rebuilt.numpy(), np.asarray(jrebuilt), atol=1e-6, rtol=0)
    ctok = actions.discretize_coords(_t(bb), 384)
    np.testing.assert_array_equal(ctok.numpy(), np.asarray(jax_actions.discretize_coords(
        jnp.asarray(bb), 384)))
    np.testing.assert_allclose(actions.undiscretize_coords(ctok, 384).numpy(), np.asarray(
        jax_actions.undiscretize_coords(jnp.asarray(np.asarray(ctok)), 384)), atol=1e-7, rtol=0)
    smooth = actions.smooth_gt_leaving_frame(acts, _t(bb))
    jsmooth = jax_actions.smooth_gt_leaving_frame(jnp.asarray(data["actions"]), jnp.asarray(bb))
    np.testing.assert_allclose(smooth.numpy(), np.asarray(jsmooth), atol=1e-6, rtol=0)


def test_reshape_data_is_a_scatter_add():
    """Null rows (-1) add zeros to slot 0; valid ids land in their slot."""
    rng = np.random.default_rng(2)
    vals = rng.standard_normal((2, 3, 5, 4)).astype(np.float32)
    ids = np.asarray([[[2, 0, -1, 1, -1], [-1, -1, 0, 3, 4], [4, 3, 2, 1, 0]],
                      [[0, -1, -1, -1, -1], [1, 0, -1, 2, -1], [-1, 2, 1, 0, 3]]])
    got = actions.reshape_data(_t(vals), _t(ids))
    want = jax_actions.reshape_data(jnp.asarray(vals), jnp.asarray(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _collated_objects():
    """One batch of the synthetic loader, as the tools get it, with raw
    track ids that repeat, hop between slots and leave padding zeros."""
    ds, loader = get_dataloader(".", "synthetic", if_train=True, batch_size=2,
                                clip_length=CFG.num_timesteps, train_H=64, train_W=96, seed=0)
    objects = next(iter(loader))["objects"]
    tid = objects["track_id"].numpy().copy()
    tid[0, 1] = np.roll(tid[0, 1], 2)
    tid[1, :, 0] = 0  # id 0 in slot 0 is a real id
    objects["track_id"] = torch.from_numpy(tid)
    return ds, objects


@pytest.mark.parametrize("variant", ["actions", "coords", "smooth"])
def test_process_data_matches_jax(variant):
    ds, objects = _collated_objects()
    kw = dict(pred_coords=variant == "coords", smooth_gt_leaving_frame=variant == "smooth")
    size = (ds.orig_W, ds.orig_H)
    got = process_data(BaselineConfig.tiny(device="cpu", **kw), objects, size)
    want = jax_process_data(JaxConfig.tiny(**kw), {k: v.numpy() for k, v in objects.items()},
                            size)
    assert got.keys() == want.keys()
    for k in got:
        if want[k] is None:
            assert got[k] is None, k
            continue
        w = np.asarray(want[k])
        assert got[k].dtype == torch.from_numpy(w.copy()).dtype, k
        if w.dtype == bool:
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), w, atol=1e-6, rtol=0, err_msg=k)
    ids = objects["track_id"].numpy()
    np.testing.assert_array_equal(actions.normalize_track_ids(ids, 30),
                                  jax_actions.normalize_track_ids(ids, 30))


def test_process_data_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, objects = _collated_objects()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        process_data(BaselineConfig.tiny(), objects, (96, 64))


# --- the model ---------------------------------------------------------------

VARIANTS = {
    "tokens": dict(),
    "coords_token": dict(pred_coords=True),
    "regression": dict(pred_coords=True, regression=True, existence_head=True),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_model_forward_and_loss_match_jax(variant):
    kw = VARIANTS[variant]
    cfg, jcfg = BaselineConfig.tiny(device="cpu", **kw), JaxConfig.tiny(**kw)
    jmodel, params, port, data = _models(cfg, jcfg)
    want = jax.jit(jmodel.apply)(params, _jax(data))
    with torch.no_grad():
        got = port(_port(data))
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        if w.dtype in (np.int32, bool):
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
        else:
            assert _rel_l2(got[k].numpy(), w) < 1e-5, (k, _rel_l2(got[k].numpy(), w))
    assert not bool(got["valid_batch"][0]) or bool(got["valid_batch"].all())
    loss = BboxPredictorLM.loss(cfg, got)
    jloss = float(JaxLM.loss(jcfg, want))
    assert abs(float(loss) - jloss) <= 1e-5 * abs(jloss), (float(loss), jloss)


def test_image_tokens_reach_the_encoder_memory():
    cfg, jcfg = BaselineConfig.tiny(device="cpu"), JaxConfig.tiny()
    jmodel, params, port, data = _models(cfg, jcfg)
    tokens = np.random.default_rng(4).standard_normal((2, 3, cfg.hidden_dim)).astype(np.float32)
    want = jax.jit(jmodel.apply)(params, _jax(data), jnp.asarray(tokens))["action_preds"]
    with torch.no_grad():
        got = port(_port(data), _t(tokens))["action_preds"]
    assert _rel_l2(got.numpy(), np.asarray(want)) < 1e-5


def _jax_decay_mask(monkeypatch, params):
    tool = _jax_tool(monkeypatch, "train_bbox_baseline")
    mask = tool.decay_mask(params)
    from flax import traverse_util

    leaves = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(mask, sep="/").items()}
    return {k: bool(v) for k, v in flax_to_state_dict(leaves).items()}


def test_train_steps_match_optax(monkeypatch):
    """Three updates of the tool's step (clip 1.0, AdamW, a warm-up of 2, the
    decay mask) against the JAX tool's optax chain on the same batches."""
    import optax

    cfg = BaselineConfig.tiny(device="cpu", lr=5e-3, lr_warmup_steps=2, weight_decay=0.1)
    jcfg = JaxConfig.tiny(lr=5e-3, lr_warmup_steps=2, weight_decay=0.1)
    jmodel, params, port, data = _models(cfg, jcfg, seed=5)
    port.train()
    mask = _jax_decay_mask(monkeypatch, params)
    assert mask == train_bbox_baseline.decay_mask(port)
    assert not all(mask.values()) and any(mask.values())

    tool = _jax_tool(monkeypatch, "train_bbox_baseline")
    schedule = optax.join_schedules(
        [optax.linear_schedule(0.0, jcfg.lr, jcfg.lr_warmup_steps),
         optax.constant_schedule(jcfg.lr)], [jcfg.lr_warmup_steps])
    tx = optax.chain(optax.clip_by_global_norm(jcfg.gradient_clip_val),
                     optax.adamw(schedule, weight_decay=jcfg.weight_decay,
                                 mask=tool.decay_mask(params)))

    @jax.jit
    def jstep(p, s, d):
        loss, grads = jax.value_and_grad(lambda q: JaxLM.loss(jcfg, jmodel.apply(q, d)))(p)
        updates, s = tx.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    ptx = train_bbox_baseline.make_tx(cfg, port)
    named = dict(port.named_parameters())
    state = ptx.init(named)
    jstate = tx.init(params)
    # With every agent present, the JAX layer's key padding masks every key
    # (ROADMAP §3): the attention is then uniform, the queries and keys (and,
    # here, the encoder) have no effect on the loss, and their gradients are
    # rounding noise.
    grads = torch.autograd.grad(train_bbox_baseline.loss_fn(cfg, port, _port(_batch(cfg, seed=10))),
                                list(named.values()))
    norms = {k: float(g.norm()) for k, g in zip(named, grads)}
    total = float(np.sqrt(sum(v * v for v in norms.values())))
    flat_grad = {k for k, v in norms.items() if v < 1e-6 * total}
    assert flat_grad and len(flat_grad) < len(norms)
    lr_sum = sum(ptx.schedule(i) for i in range(3))
    for i in range(3):
        batch = _batch(cfg, seed=10 + i)
        params, jstate, jloss = jstep(params, jstate, _jax(batch))
        loss = train_bbox_baseline.loss_fn(cfg, port, _port(batch))
        grads = torch.autograd.grad(loss, list(named.values()))
        ptx.update(dict(zip(named, grads)), state, named)
        assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss)), (i, loss.item())
    want = flax_to_state_dict(flat(params))
    got = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    for k, w in want.items():
        if k in flat_grad:
            # Exactly zero gradient but for rounding, which Adam scales up to
            # whole steps of lr: the step is bounded, its sign is noise.
            assert np.abs(got[k] - w.numpy()).max() <= 2 * lr_sum, k
        else:
            assert _rel_l2(got[k], w.numpy()) < 1e-5, k


# --- the policy ----------------------------------------------------------------

def _rollout_draws(rng, steps, shape):
    """The Gumbel draws of the JAX policy's rollout from ``rng``."""
    draws = []
    for _ in range(steps):
        rng, key = jax.random.split(rng)
        draws.append(np.asarray(jax.random.gumbel(key, shape, jnp.float32)))
    return torch.from_numpy(np.stack(draws))


def test_rollout_with_jax_draws_matches_jax():
    cfg, jcfg = BaselineConfig.tiny(device="cpu"), JaxConfig.tiny()
    jmodel, params, port, data = _models(cfg, jcfg, seed=6)
    rng = jax.random.PRNGKey(7)
    want = JaxPolicy(jcfg, jmodel, params).rollout(_jax(data), rng, temperature=0.7)
    k, t, n = cfg.initial_frames_condition_num, cfg.num_timesteps, cfg.max_num_agents
    draws = _rollout_draws(rng, t - k, (2, n, 2, cfg.vocabulary_size))
    got = BboxPredictorLMPolicy(cfg, port).rollout(_port(data), temperature=0.7, gumbel=draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # without draws: a generator on the model's device, same shapes, seeded
    g = torch.Generator().manual_seed(0)
    a = BboxPredictorLMPolicy(cfg, port).rollout(_port(data), g)
    b = BboxPredictorLMPolicy(cfg, port).rollout(_port(data), torch.Generator().manual_seed(0))
    assert a.shape == got.shape and torch.equal(a, b)


def test_render_and_score_match_jax():
    cfg, jcfg = BaselineConfig.tiny(device="cpu", **TINY), JCFG
    data = _batch(cfg, seed=8)
    boxes, types = data["bboxes"][0], data["type_ids"][0]
    policy = BboxPredictorLMPolicy(cfg, None)
    got = policy.render(boxes, types)
    want = JaxPolicy(jcfg, None, None).render(boxes, types)
    assert got.shape == want.shape == (cfg.num_timesteps, cfg.train_H, cfg.train_W, 3)
    differ = np.any(np.abs(got - want) > 1.5 / 255, axis=-1).mean()
    assert differ < 2e-3, differ
    shifted = policy.render(data["bboxes"][1], types)
    s_got, s_want = policy.score(shifted, got), JaxPolicy(jcfg, None, None).score(shifted, got)
    assert s_got.keys() == s_want.keys()
    for k in s_got:
        assert abs(s_got[k] - s_want[k]) <= 1e-6, k


# --- the commands ----------------------------------------------------------------

def _losses(text):
    return [(int(s), float(v)) for s, v in re.findall(r"^step (\d+) loss ([-0-9.]+)", text, re.M)]


def test_commands_match_the_jax_tools(monkeypatch, tmp_path):
    """``train_bbox_baseline`` for 20 steps and ``eval_bbox_baseline`` on 2
    clips, from the JAX tool's initial parameters and with its rollout draws,
    against the JAX tools on the same synthetic data."""
    monkeypatch.chdir(tmp_path)
    jtrain = _jax_tool(monkeypatch, "train_bbox_baseline")
    jeval = _jax_tool(monkeypatch, "eval_bbox_baseline")
    steps, samples = 20, 2

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jparams = jtrain.main(cfg=JCFG, max_steps=steps)
    jlosses = _losses(out.getvalue())
    assert [s for s, _ in jlosses] == [1, 20]

    # the JAX tool's init: its model at PRNGKey(seed), whose values depend on shapes alone
    ds, loader = get_dataloader(".", "synthetic", if_train=True, batch_size=2,
                                clip_length=CFG.num_timesteps, train_H=64, train_W=96, seed=0)
    data0 = jax_process_data(JCFG, {k: v.numpy() for k, v in next(iter(loader))["objects"].items()},
                             (ds.orig_W, ds.orig_H))
    init = JaxLM(cfg=JCFG).init(jax.random.PRNGKey(JCFG.seed), data0)
    out = io.StringIO()
    history = []
    with contextlib.redirect_stdout(out):
        model = train_bbox_baseline.main(cfg=CFG, max_steps=steps,
                                         init_state=flax_to_state_dict(flat(init)),
                                         history=history)
    losses = _losses(out.getvalue())
    assert [s for s, _ in losses] == [1, 20] and len(history) == steps
    for (_, a), (_, b) in zip(losses, jlosses):
        assert abs(a - b) <= 1e-4, (losses, jlosses)  # one unit of the printed digit
    want = flax_to_state_dict(flat(jparams))
    state = model.state_dict()
    assert _rel_l2(np.concatenate([state[k].numpy().ravel() for k in want]),
                   np.concatenate([w.numpy().ravel() for w in want.values()])) < 1e-4
    for k, w in want.items():  # (some tensors sit at 1e-13: see test_train_steps_match_optax)
        np.testing.assert_allclose(state[k].numpy(), w.numpy(), atol=1e-5, rtol=1e-3, err_msg=k)

    # the port's checkpoint restores bit for bit
    ckpt = CheckpointManager(train_bbox_baseline.CHECKPOINT_DIR)
    assert ckpt.all_steps() == [steps]
    fresh = train_bbox_baseline.build_model(CFG, torch.device("cpu")).state_dict()
    restored = ckpt.restore(template=fresh)
    assert all(torch.equal(restored[k], v) for k, v in state.items())

    jsummary = jeval.main(cfg=JCFG, num_samples=samples, params=jparams)
    rng = jax.random.PRNGKey(JCFG.seed)
    draws = []
    k, t, n = CFG.initial_frames_condition_num, CFG.num_timesteps, CFG.max_num_agents
    for _ in range(samples):
        rng, key = jax.random.split(rng)
        draws.append(_rollout_draws(key, t - k, (1, n, 2, CFG.vocabulary_size)))
    port = BboxPredictorLM(CFG)
    port.load_state_dict(want, strict=True)
    hist = []
    summary = eval_bbox_baseline.main(cfg=CFG, num_samples=samples, model=port, gumbel=draws,
                                      history=hist)
    assert summary.keys() == jsummary.keys() and len(hist) == samples
    for key in summary:
        assert abs(summary[key] - jsummary[key]) <= 1e-6, (key, summary, jsummary)
    gifs = sorted(os.listdir(eval_bbox_baseline.OUT_DIR))
    assert gifs == [f"rollout_{i}.gif" for i in range(samples)]

    # and from its own checkpoint, as a user runs it
    assert eval_bbox_baseline.main(cfg=CFG, num_samples=1).keys() == summary.keys()


def test_commands_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = config_from_overrides(["dataset=synthetic", "max_steps=1", "train_W=96",
                                 "train_H=64"])
    assert cfg.device is None and cfg.max_steps == 1 and cfg.dataset == "synthetic"
    for main in (train_bbox_baseline.main, eval_bbox_baseline.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(cfg=cfg)


def test_overrides_parse_like_the_jax_parser():
    from ctrlv_tpu.baseline.config import config_from_overrides as jax_overrides

    args = ["condition_last_frame=no", "hidden_dim=64", "lr=1e-3", "dataset=bdd100k",
            "existence_head=1"]
    got, want = config_from_overrides(args), jax_overrides(args)
    for f in ("condition_last_frame", "hidden_dim", "lr", "dataset", "existence_head"):
        assert getattr(got, f) == getattr(want, f)
    assert config_from_overrides(["device=cpu"]).device == "cpu"
    with pytest.raises(SystemExit):
        config_from_overrides(["nonsense=1"])
