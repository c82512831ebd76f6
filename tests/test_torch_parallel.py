"""The port's mesh, ZeRO-1 plan and data-parallel training steps.

The mesh rule and the ZeRO-1 plan are held against the JAX package's
``make_train_mesh`` and ``zero1_sharding_tree`` (the conftest gives JAX 8
virtual CPU devices). The training steps run on two ``gloo`` ranks in
spawned processes (``tests/torch_dist_cases.py``) and are held against the
port's one-rank step on the same global batch, which the other test files
hold against the JAX step.

Tolerance: f32 on the CPU. Two ranks compute each row's forward and
backward as one rank does, but the mean of the gradients over the batch is
summed in another order (two halves, then the all-reduce), so the losses
agree to 1e-6 relative and the gradient norms to 1e-5. An Adam step is lr
times m / sqrt(v), which normalises a gradient's size away: where an
element's gradient is a near-cancelling sum over the batch, the order of
that sum moves the step by a fraction of lr (at lr 1e-4 a bias moved 3.7e-6
apart after two updates). At the ControlNet step test's lr of 1e-5 the
parameters and the optimizer state agree to 1e-6 absolute (4.6e-7 measured)
and the parameters' change over the two updates to 1e-3 relative L2 of the
one-rank change (1.8e-4 measured).
"""

import itertools
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax

from ctrlv_tpu.parallel import make_train_mesh as jax_make_train_mesh
from ctrlv_tpu.parallel import make_mesh as jax_make_mesh
from ctrlv_tpu.parallel import zero1_sharding_tree
from ctrlv_tpu_torch.parallel import (
    make_mesh,
    make_train_mesh,
    shares,
    train_mesh_shape,
    zero1_plan,
)
from ctrlv_tpu_torch.parallel.launch import spawn
import torch_dist_cases as cases

torch.set_num_threads(1)


@pytest.mark.parametrize("world,n_frame", [(1, 1), (2, 1), (4, 1), (8, 1), (4, 2), (8, 2),
                                           (6, 1), (8, 4)])
def test_train_mesh_shape_matches_jax(world, n_frame):
    for batch in (1, 2, 3, 4, 5, 6, 8, 12):
        ref = jax_make_train_mesh(batch, None, n_frame, devices=jax.devices()[:world])
        assert train_mesh_shape(batch, world, None, n_frame) == (
            ref.shape["data"], ref.shape["frame"]), batch
        for n_data in (1, 2, 3, 4):
            if n_data * n_frame > world:
                continue
            try:
                ref = jax_make_train_mesh(batch, n_data, n_frame,
                                          devices=jax.devices()[:world])
            except ValueError as e:
                with pytest.raises(ValueError, match="does not divide the global batch"):
                    train_mesh_shape(batch, world, n_data, n_frame)
                assert "does not divide" in str(e)
                continue
            assert train_mesh_shape(batch, world, n_data, n_frame) == (
                ref.shape["data"], ref.shape["frame"])


SHAPES = {
    "conv": (320, 320, 3, 3), "proj": (1280, 5120), "bias": (1280,), "small": (64, 64),
    "odd": (99, 165), "ties": (256, 256), "col": (5120, 1280), "embed": (2, 16384),
    "vector": (16384,), "three": (24, 640, 7),
}


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_zero1_plan_matches_jax(n):
    leaves = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    specs = zero1_sharding_tree(leaves, jax_make_mesh(n, 1, jax.devices()[:n]))
    plan = zero1_plan(SHAPES, n)
    for name, sharding in specs.items():
        spec = tuple(sharding.spec) + (None,) * (len(SHAPES[name]) - len(sharding.spec))
        axis = spec.index("data") if "data" in spec else None
        assert plan[name] == axis, (name, spec)
    assert any(a is not None for a in plan.values()) is (n > 1)


def test_shares_split_contiguously():
    assert shares(25, 2) == [(0, 13), (13, 25)]
    assert shares(5, 2) == [(0, 3), (3, 5)]
    assert shares(5, 4) == [(0, 2), (2, 3), (3, 4), (4, 5)]
    assert shares(2, 1) == [(0, 2)]
    for n, parts in itertools.product(range(1, 30), range(1, 9)):
        b = shares(n, parts)
        assert b[0][0] == 0 and b[-1][1] == n and len(b) == parts
        assert max(h - lo for lo, h in b) - min(h - lo for lo, h in b) <= 1


def test_a_mesh_above_one_rank_needs_a_process_group():
    with pytest.raises(RuntimeError, match="torchrun"):
        make_mesh(2, 1, ranks=2)
    with pytest.raises(RuntimeError, match="torchrun"):
        make_mesh(1, 2, ranks=2)
    lone = make_train_mesh(4)
    assert lone.shape == {"data": 1, "frame": 1} and lone.device_mesh is None and lone.active
    with pytest.raises(ValueError, match="does not divide"):
        make_train_mesh(3, n_data=2)


def _run(tmp_path, name, fn, *args, world=2, beside=None):
    """``fn`` on ``world`` ranks: what each wrote. ``beside()`` runs in this
    process while spawned ranks run; then its result comes first."""
    out = str(tmp_path / name)
    if world == 1:
        fn(0, 1, out, *args)
    else:
        with ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(spawn, fn, world, "cpu", (out, *args), store_dir=str(tmp_path))
            first = beside() if beside else None
            ranks.result()
    runs = [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(world)]
    return (first, runs) if beside else runs


def _assert_state_close(got, want, path="", atol=1e-6):
    if isinstance(want, torch.Tensor):
        assert got.shape == want.shape and got.dtype == want.dtype, path
        torch.testing.assert_close(got, want, rtol=0, atol=atol, msg=path)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_state_close(got[k], want[k], f"{path}/{k}", atol)
    else:
        assert got == want, path


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """The one-rank runs, by (kind, optimizer)."""
    cache = {}

    def get(kind, optimizer="adamw"):
        if (kind, optimizer) not in cache:
            tmp = tmp_path_factory.mktemp(f"{kind}_{optimizer}")
            cache[kind, optimizer] = _run(tmp, "one", cases.train_case, kind, False, optimizer,
                                          world=1)[0]
        return cache[kind, optimizer]

    return get


def _assert_matches(run, ref, kind):
    np.testing.assert_allclose(run["losses"], ref["losses"], rtol=1e-6)
    np.testing.assert_allclose(run["norms"], ref["norms"], rtol=1e-5)
    _assert_state_close(run["params"], ref["params"])
    _assert_state_close(run["opt_state"], ref["opt_state"])
    initial = dict(cases.micro_models()["ctrl" if kind == "controlnet" else "unet"]
                   .named_parameters())
    diff = sum(((run["params"][k] - p) ** 2).sum() for k, p in ref["params"].items())
    change = sum(((p - initial[k].detach()) ** 2).sum() for k, p in ref["params"].items())
    assert change > 0 and (diff / change).sqrt() < 1e-3


@pytest.mark.parametrize("kind", ["controlnet", "svd_temporal"])
def test_two_ranks_train_as_one(tmp_path, one_rank, kind):
    """Two data ranks, each on half the global batch, replicated optimizer
    state: the one-rank losses, gradient norms, parameters and state."""
    ref, ranks = _run(tmp_path, "two", cases.train_case, kind, False,
                      beside=lambda: one_rank(kind))
    for run in ranks:
        assert run["sliced"] == []
        _assert_matches(run, ref, kind)
    for k in ref["params"]:  # the same parameters on both ranks
        assert torch.equal(ranks[0]["params"][k], ranks[1]["params"][k]), k


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_zero1_at_two_ranks_equals_one_rank(tmp_path, one_rank, optimizer):
    """ZeRO-1: each rank holds half of every planned moment, accumulated
    gradient and master, along the planned axis; the gathered state and the
    parameters are the one-rank ones."""
    ref, ranks = _run(tmp_path, "zero1", cases.train_case, "controlnet", True, optimizer,
                      beside=lambda: one_rank("controlnet", optimizer))
    full = cases.sharded_shapes(ref["opt_state"])
    plan = zero1_plan({k: tuple(p.shape) for k, p in ref["params"].items()}, 2,
                      cases.ZERO1_MIN_SIZE)
    sliced = sorted(k for k, a in plan.items() if a is not None)
    assert sliced and ranks[0]["sliced"] == sliced == ranks[1]["sliced"]
    for run in ranks:
        _assert_matches(run, ref, "controlnet")
        assert sorted(run["local_shapes"]) == sorted(full)
        for path, shape in full.items():
            name = path.rsplit("/", 1)[1]
            want = list(shape)
            if plan[name] is not None:
                want[plan[name]] //= 2
            assert run["local_shapes"][path] == tuple(want), path
    kinds = {p.split("/")[-2] for p in full}
    assert kinds == ({"master", "acc_grads", "mu", "nu"} if optimizer == "adamw"
                     else {"master", "acc_grads"})
