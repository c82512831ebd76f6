"""The port's optimizer regimes, EMA and LoRA against optax and the JAX package.

Adafactor with the arguments the JAX factory passes, the masked optimizer
(``optax.multi_transform``), ``scheduled_freeze`` across its switch step,
``ema_update`` and ``apply_lora`` / ``merge_lora``. Inputs are seeded numpy
arrays; everything is f32 on the CPU.

Layouts. The JAX trees hold flax kernels, the port's dictionaries hold what
``nn.Linear`` and ``nn.Conv2d`` store, so parameters and gradients are mapped
before they are compared:

    Linear (in, out) -> (out, in)         Conv2d (kh, kw, in, out) -> (out, in, kh, kw)

Adafactor factors a leaf over its two largest axes, which are the same two
logical axes in either layout: ``v_row`` (indexed by the smaller of the two)
and ``v_col`` compare after moving the kernel axes behind, (kh, kw, n) ->
(n, kh, kw). On a square matrix the tie falls on other logical axes in the two
layouts; the update is the same function of the gradient either way.

Tolerance: 1e-6 absolute on parameters of order 1 after 7 updates at a
learning rate of 1e-2: the same f32 arithmetic in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ctrlv_tpu.train import ema as jax_ema
from ctrlv_tpu.train import lora as jax_lora
from ctrlv_tpu.train.state import make_optimizer as jax_make_optimizer
from ctrlv_tpu.train.state import temporal_blocks_predicate as jax_temporal_predicate
from ctrlv_tpu.train.state import vae_decoder_predicate as jax_decoder_predicate
from ctrlv_tpu_torch.convert import flax_to_state_dict
from ctrlv_tpu_torch.train import (
    Adafactor,
    Masked,
    ScheduledFreeze,
    apply_lora,
    ema_init,
    ema_update,
    lora_applied,
    lora_init,
    make_optimizer,
    merge_lora,
    merge_trainable,
    split_trainable,
    temporal_blocks_predicate,
    trainable_mask,
    vae_decoder_predicate,
)
from ctrlv_tpu_torch.train.state import _factored_dims

torch.set_num_threads(1)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def to_port_layout(arr):
    arr = np.asarray(arr)
    if arr.ndim == 2:
        return arr.T
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    return arr


def to_jax_layout(arr):
    arr = np.asarray(arr)
    if arr.ndim == 2:
        return arr.T
    if arr.ndim == 4:
        return arr.transpose(2, 3, 1, 0)
    return arr


SHAPES = {
    "big/kernel": (130, 140),  # both axes reach 128: factored
    "square/kernel": (128, 128),  # factored, a tie between the axes
    "small/kernel": (5, 7),  # below the threshold: a full second moment
    "conv/kernel": (3, 3, 128, 130),  # factored over (in, out), one pair per tap
    "vec/bias": (140,),
}


def tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}


def run_optax(tx, params, grads_seq):
    params = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(params)
    update = jax.jit(tx.update)
    trail = []
    for g in grads_seq:
        updates, state = update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, updates)
        trail.append({k: np.asarray(v) for k, v in params.items()})
    return trail, state


def run_port(tx, params, grads_seq):
    params = {k: t(to_port_layout(v)).clone() for k, v in params.items()}
    state = tx.init(params)
    trail = []
    for g in grads_seq:
        state = tx.update({k: t(to_port_layout(v)) for k, v in g.items()}, state, params)
        trail.append({k: to_jax_layout(v.numpy()).copy() for k, v in params.items()})
    return trail, state


def assert_trails_match(trail, ref, atol=1e-6):
    assert len(trail) == len(ref)
    for step, (a, b) in enumerate(zip(trail, ref)):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], atol=atol, rtol=0, err_msg=f"step {step} {k}")


@pytest.mark.parametrize("grad_scale", [0.002, 3.0], ids=["clip-off", "clip-on"])
@pytest.mark.parametrize("kwargs", [dict(), dict(adam_weight_decay=0.3, adam_epsilon=1e-3),
                                    dict(lr_scheduler="cosine", lr_warmup_steps=3,
                                         max_train_steps=10)],
                         ids=["defaults", "hyper", "cosine"])
def test_adafactor_matches_optax(kwargs, grad_scale):
    kw = dict(learning_rate=1e-2, nan_guard_steps=0, optimizer="adafactor", **kwargs)
    grads = [tree(10 + i, grad_scale) for i in range(7)]
    ref, ref_state = run_optax(jax_make_optimizer(**kw), tree(0), grads)
    tx = make_optimizer(**kw)
    assert isinstance(tx, Adafactor)
    out, state = run_port(tx, tree(0), grads)
    assert_trails_match(out, ref)
    assert np.abs(ref[-1]["big/kernel"] - tree(0)["big/kernel"]).max() > 1e-3  # it did move
    factored = ref_state[1][0]  # chain(clip, chain(scale_by_factored_rms, ...))
    assert int(factored.count) == state["count"] == 7
    assert set(state["v"]) == {"small/kernel", "vec/bias"}
    assert set(state["v_row"]) == set(state["v_col"]) == {"big/kernel", "square/kernel",
                                                          "conv/kernel"}

    def behind(a):
        return np.asarray(a).transpose(2, 0, 1) if np.ndim(a) == 3 else np.asarray(a)

    for k in ("big/kernel", "conv/kernel"):
        np.testing.assert_allclose(state["v_row"][k].numpy(), behind(factored.v_row[k]),
                                   rtol=1e-5, atol=1e-12, err_msg=k)
        np.testing.assert_allclose(state["v_col"][k].numpy(), behind(factored.v_col[k]),
                                   rtol=1e-5, atol=1e-12, err_msg=k)
    np.testing.assert_allclose(state["v"]["small/kernel"].numpy(),
                               np.asarray(factored.v["small/kernel"]).T, rtol=1e-5, atol=1e-12)


def test_adafactor_keeps_the_factory_epsilon_quirk():
    """``eps=adam_epsilon`` stands beside the squared gradient, where optax's
    own default is 1e-30: with zero gradients the second moment is the
    epsilon, not 1e-30."""
    tx = make_optimizer(learning_rate=1e-2, nan_guard_steps=0, optimizer="adafactor",
                        adam_epsilon=1e-3)
    params = {"w": torch.ones(4, 3)}
    state = tx.update({"w": torch.zeros(4, 3)}, tx.init(params), params)
    np.testing.assert_allclose(state["v"]["w"].numpy(), 1e-3 * (1 - (1 - 1.0**-0.8)), rtol=1e-6)
    assert _factored_dims((130, 140), 128) == (0, 1) and _factored_dims((140, 130), 128) == (1, 0)
    assert _factored_dims((127, 500), 128) is None and _factored_dims((500,), 128) is None
    assert _factored_dims((130, 128, 3, 3), 128) == (1, 0)
    with pytest.raises(ValueError):
        make_optimizer(optimizer="sgd")


MASK = {"big/kernel": True, "square/kernel": False, "small/kernel": True, "conv/kernel": False,
        "vec/bias": True}


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_mask_matches_multi_transform(optimizer):
    """Frozen leaves get exactly zero and the clip sees the live gradients
    only: with every gradient at scale 3 the clip is active either way, and
    a norm over all leaves would shrink the live updates further."""
    kw = dict(learning_rate=1e-2, nan_guard_steps=0, optimizer=optimizer)
    grads = [tree(20 + i, 3.0) for i in range(5)]
    ref, _ = run_optax(jax_make_optimizer(mask=MASK, **kw), tree(0), grads)
    tx = make_optimizer(mask=MASK, **kw)
    assert isinstance(tx, Masked)
    out, state = run_port(tx, tree(0), grads)
    assert_trails_match(out, ref)
    start = tree(0)
    for k, live in MASK.items():
        assert np.array_equal(out[-1][k], start[k]) is (not live), k
    moments = state["inner"]["mu"] if optimizer == "adamw" else (
        state["inner"]["v"] | state["inner"]["v_row"])
    assert set(moments) == {k for k, live in MASK.items() if live}  # none for the frozen


def test_partitioned_update_equals_the_masked_one():
    """A subset handed to the plain optimizer moves as the full set under the mask."""
    kw = dict(learning_rate=1e-2, nan_guard_steps=0, mu_dtype="bfloat16")
    grads = [tree(30 + i, 3.0) for i in range(4)]
    masked, _ = run_port(make_optimizer(mask=MASK, **kw), tree(0), grads)
    live = lambda d: {k: v for k, v in d.items() if MASK[k]}  # noqa: E731
    subset, _ = run_port(make_optimizer(**kw), live(tree(0)), [live(g) for g in grads])
    for a, b in zip(subset, masked):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("optimizer,start", [("adamw", 3), ("adamw", 0), ("adafactor", 3),
                                             ("adamw", 100)])
def test_scheduled_freeze_matches_jax_across_its_switch(optimizer, start):
    kw = dict(learning_rate=1e-2, nan_guard_steps=0, optimizer=optimizer, adam_weight_decay=0.1)
    grads = [tree(40 + i, 1.0) for i in range(7)]
    ref, _ = run_optax(jax_make_optimizer(scheduled_mask=MASK, freeze_start_iter=start, **kw),
                       tree(0), grads)
    tx = make_optimizer(scheduled_mask=MASK, freeze_start_iter=start, **kw)
    assert isinstance(tx, ScheduledFreeze)
    out, state = run_port(tx, tree(0), grads)
    assert_trails_match(out, ref)
    frozen = [k for k, live in MASK.items() if not live]
    for i in range(1, 7):
        for k in frozen:  # full updates before the switch, none from it on: no weight decay either
            assert np.array_equal(out[i][k], out[i - 1][k]) is (i >= start), (i, k)
    assert state["count"] == 7
    # the inner state was reset on the switch step: its count restarts there
    assert state["inner"]["count"] == (7 - start if 0 <= start < 7 else 7)


def test_predicates_and_subsets():
    names = ["down_blocks.0.attentions.0.temporal_transformer_blocks.0.attn1.to_q.weight",
             "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight",
             "down_blocks.0.resnets.0.temporal_res_block.conv1.weight", "conv_in.weight"]
    for name in names:
        assert temporal_blocks_predicate(name) == jax_temporal_predicate(tuple(name.split(".")))
    assert [temporal_blocks_predicate(n) for n in names] == [True, False, False, False]
    for name in ("decoder.conv_in.weight", "encoder.conv_in.weight", "quant_conv.bias"):
        assert vae_decoder_predicate(name) == jax_decoder_predicate(tuple(name.split(".")))
    net = torch.nn.ModuleDict({"temporal_transformer_blocks": torch.nn.Linear(3, 2),
                               "other": torch.nn.Linear(3, 2)})
    mask = trainable_mask(net, temporal_blocks_predicate)
    assert mask == {"temporal_transformer_blocks.weight": True,
                    "temporal_transformer_blocks.bias": True,
                    "other.weight": False, "other.bias": False}
    sub = split_trainable(net, temporal_blocks_predicate)
    assert set(sub) == {k for k, v in mask.items() if v}
    assert sub["temporal_transformer_blocks.weight"] is net["temporal_transformer_blocks"].weight
    assert [p.requires_grad for p in net.parameters()] == [True, True, False, False]
    full = dict(net.named_parameters())
    replaced = {"other.bias": torch.zeros(2)}
    merged = merge_trainable(full, replaced)
    assert merged["other.bias"] is replaced["other.bias"] and set(merged) == set(full)
    assert merged["other.weight"] is full["other.weight"]


@pytest.mark.parametrize("max_decay", [0.9999, 0.5])
def test_ema_update_matches_jax(max_decay):
    rng = np.random.default_rng(50)
    start = {"a": rng.standard_normal((4, 3)).astype(np.float32),
             "b": rng.standard_normal((5,)).astype(np.float32)}
    ref = jax_ema.ema_init({k: jnp.asarray(v) for k, v in start.items()})
    ema = ema_init({k: t(v) for k, v in start.items()})
    assert ema.step == 0 and ema.params["a"].data_ptr() != t(start["a"]).data_ptr()
    for i in range(12):
        new = {k: (v + 0.1 * (i + 1) * rng.standard_normal(v.shape)).astype(np.float32)
               for k, v in start.items()}
        ref = jax_ema.ema_update(ref, {k: jnp.asarray(v) for k, v in new.items()}, max_decay)
        ema = ema_update(ema, {k: t(v) for k, v in new.items()}, max_decay)
        for k in start:
            np.testing.assert_allclose(ema.params[k].numpy(), np.asarray(ref.params[k]),
                                       atol=1e-6, rtol=0, err_msg=f"step {i} {k}")
    assert ema.step == int(ref.step) == 12
    module = torch.nn.Linear(3, 2)
    from_module = ema_init(module)
    assert set(from_module.params) == {"weight", "bias"}
    assert not from_module.params["weight"].requires_grad


def _lora_tree():
    rng = np.random.default_rng(60)
    normal = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"blk": {"attn1": {"to_q": {"kernel": normal(8, 6)}, "to_k": {"kernel": normal(8, 6)},
                              "to_v": {"kernel": normal(8, 6)},
                              "to_out_0": {"kernel": normal(6, 8), "bias": normal(8)}},
                    "ff": {"proj": {"kernel": normal(8, 16), "bias": normal(16)}}}}


@pytest.mark.parametrize("scale", [1.0, 0.25])
def test_apply_and_merge_lora_match_jax(scale):
    from flax import traverse_util

    params = jax.tree.map(jnp.asarray, _lora_tree())
    jl = jax_lora.lora_init(jax.random.PRNGKey(3), params, rank=4)
    rng = np.random.default_rng(61)
    jl = {path: {"a": ab["a"], "b": jnp.asarray(rng.standard_normal(ab["b"].shape), jnp.float32)}
          for path, ab in jl.items()}
    want = jax_lora.apply_lora(params, jl, scale)
    flat = lambda tr: {k: np.asarray(v) for k, v in  # noqa: E731
                       traverse_util.flatten_dict(tr, sep="/").items()}
    base = flax_to_state_dict(flat(params))
    # the adapters keep the JAX shapes: their leaves are no kernels and pass as they are
    adapters = flax_to_state_dict(
        {"/".join(path[:-1]) + f"/lora_{leaf}": np.asarray(ab[leaf])
         for path, ab in jl.items() for leaf in ("a", "b")})
    lora = lora_init({k: v for k, v in adapters.items() if k.endswith("lora_a")}, base, rank=4)
    assert set(lora) == set(adapters) and "blk.attn1.to_out.0.lora_a" in lora
    assert all(float(v.detach().abs().max()) == 0 for k, v in lora.items()
               if k.endswith("lora_b"))
    with torch.no_grad():
        for k in lora:
            if k.endswith("lora_b"):
                lora[k].copy_(adapters[k])
    ref = flax_to_state_dict(flat(want))
    for fn in (apply_lora, merge_lora):
        out = fn(base, lora, scale)
        assert set(out) == set(ref)
        for k in ref:
            np.testing.assert_allclose(out[k].detach().numpy(), ref[k].numpy(), atol=1e-6,
                                       err_msg=k)
    assert apply_lora(base, lora, scale)["blk.attn1.to_q.weight"].requires_grad
    assert not merge_lora(base, lora, scale)["blk.attn1.to_q.weight"].requires_grad
    assert apply_lora(base, lora)["blk.ff.proj.weight"] is base["blk.ff.proj.weight"]


def test_lora_init_draws_and_lora_applied_restores():
    class Attn(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.to_q = torch.nn.Linear(6, 8, bias=False)
            self.to_out = torch.nn.ModuleList([torch.nn.Linear(8, 6)])
            self.other = torch.nn.Linear(6, 6)

        def forward(self, x):
            return self.to_out[0](self.to_q(x)) + self.other(x)

    net = Attn().requires_grad_(False)
    lora = lora_init(torch.Generator().manual_seed(0), net, rank=4)
    again = lora_init(torch.Generator().manual_seed(0), net, rank=4)
    assert set(lora) == {"to_q.lora_a", "to_q.lora_b", "to_out.0.lora_a", "to_out.0.lora_b"}
    assert lora["to_q.lora_a"].shape == (6, 4) and lora["to_q.lora_b"].shape == (4, 8)
    assert torch.equal(lora["to_q.lora_a"], again["to_q.lora_a"])
    assert 0.1 < float(lora["to_q.lora_a"].std()) < 0.5  # N(0, 1) / rank
    x = torch.randn(3, 6, generator=torch.Generator().manual_seed(1))
    base_out = net(x)
    keys = list(net.state_dict())
    with lora_applied(net, lora):
        torch.testing.assert_close(net(x), base_out)  # B = 0: no effect yet
    with torch.no_grad():
        lora["to_q.lora_b"].normal_(generator=torch.Generator().manual_seed(2))
    with lora_applied(net, lora, scale=0.5):
        out = net(x)
        grads = torch.autograd.grad(out.sum(), [lora["to_q.lora_a"], lora["to_q.lora_b"]])
    assert all(float(g.abs().max()) > 0 for g in grads)
    eff = net.to_q.weight + (lora["to_q.lora_a"] @ lora["to_q.lora_b"]).t() * 0.5
    torch.testing.assert_close(out, net.to_out[0](x @ eff.t()) + net.other(x))
    torch.testing.assert_close(net(x), base_out)  # the base weights came back untouched
    assert list(net.state_dict()) == keys and isinstance(net.to_q.weight, torch.nn.Parameter)
