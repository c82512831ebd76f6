"""The port's ControlNet training step, loss and optimizer against the JAX
package's.

Inputs are seeded numpy arrays. Random draws that the JAX functions make
from a key are made here with ``jax.random`` from the same key and handed to
the port (``draws=``, ``idx=``, ``rp=``, ``noise=``), so both sides see the
same numbers. Everything is f32 on the CPU; the models are the micro
configuration (two levels, one layer each), the smallest with every block
kind, so that the JAX step is one short jit.

Tolerances. Tables and losses: the same f32 arithmetic, 1e-6. The optimizer
against optax: 1e-6 absolute on parameters of order 1 after 7 to 12 updates
at a learning rate of 1e-2 (bf16 first moment: both sides round the same f32
value). The step: the loss to 1e-4 relative and the gradients to 1e-3
relative L2 (CLIP, three VAE encodes, ControlNet and UNet forward and
backward, each with its own order of f32 sums); parameters after two
accumulated AdamW updates at lr 1e-5 to 1e-5 absolute (an Adam step moves an
element by at most lr whatever its gradient's size), and their change over
the two updates to 1e-2 relative L2 of the reference's change. The optimizer
on a bf16 tree (bf16 parameters and both moments, as the full-width step
runs it): optax rounds every product and sum to bf16, the port computes in
f32 and rounds once, so they agree to a few bf16 ulps, not to the bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import traverse_util

from ctrlv_tpu.diffusion import training_sigma_table as jax_sigma_table
from ctrlv_tpu.models import (
    AutoencoderKLTemporalDecoder as JaxVAE,
    CLIPVisionConfig as JaxCLIPConfig,
    CLIPVisionModelWithProjection as JaxCLIP,
    ControlNetSpatioTemporal as JaxControlNet,
    UNetSpatioTemporalConditionModel as JaxUNet,
    UNetSTConfig as JaxUNetConfig,
    VAEConfig as JaxVAEConfig,
)
from ctrlv_tpu.train import loss as jax_loss
from ctrlv_tpu.train import make_controlnet_train_step as jax_make_step
from ctrlv_tpu.train.state import init_train_state as jax_init_state
from ctrlv_tpu.train.state import make_optimizer as jax_make_optimizer
from ctrlv_tpu_torch.convert import flax_to_state_dict
from ctrlv_tpu_torch.diffusion import training_sigma_table
from ctrlv_tpu_torch.models import (
    AutoencoderKLTemporalDecoder,
    CLIPVisionConfig,
    CLIPVisionModelWithProjection,
    ControlNetSpatioTemporal,
    UNetSpatioTemporalConditionModel,
    UNetSTConfig,
    VAEConfig,
)
from ctrlv_tpu_torch.train import (
    MultiSteps,
    conditioning_dropout,
    edm_denoising_loss,
    init_train_state,
    make_controlnet_train_step,
    make_optimizer,
    make_schedule,
    sample_training_sigmas,
)
from ctrlv_tpu_torch.train.train_step import _vae_encode_frames
from test_torch_convert import flat, load, seeded_params

torch.set_num_threads(1)

B, F, H, W = 2, 2, 16, 16
DROPOUT = 0.3  # high enough that the draws below drop a context and keep one
# Relative L2 of the parameters' change after two updates at lr 1e-5 against
# the reference's change: a change of 2e-5 on a weight of order 1 is resolved
# by f32 to 3e-3 of itself, and a bf16 first moment may round the other way
# where the gradients differ by 1e-3. Measured 4.8e-3.
CHANGE_TOL = 1e-2


def t(x):
    return torch.from_numpy(np.asarray(x))


# --------------------------------------------------------------------- tables, loss


def test_training_sigma_table_matches_jax():
    ref = jax_sigma_table()
    out = training_sigma_table()
    assert out.dtype == np.float32 and out.shape == (1000,)
    assert out[0] > out[-1] > 0  # descending: index 0 is the noisiest
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)
    np.testing.assert_allclose(training_sigma_table(50, 1e-4, 2e-2),
                               jax_sigma_table(50, 1e-4, 2e-2), rtol=1e-6, atol=0)


def test_sample_training_sigmas_matches_jax():
    key = jax.random.PRNGKey(4)
    sigma_ref, ts_ref = jax_loss.sample_training_sigmas(key, 6)
    idx = np.asarray(jax.random.randint(key, (6,), 0, 1000))
    sigma, ts = sample_training_sigmas(6, idx=t(idx))
    np.testing.assert_allclose(sigma.numpy(), np.asarray(sigma_ref), rtol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(ts_ref), rtol=1e-6, atol=1e-6)
    drawn, _ = sample_training_sigmas(64, generator=torch.Generator().manual_seed(0))
    again, _ = sample_training_sigmas(64, generator=torch.Generator().manual_seed(0))
    assert torch.equal(drawn, again) and len(set(drawn.tolist())) > 32


def test_edm_denoising_loss_matches_jax():
    rng = np.random.default_rng(0)
    pred, noisy, target = (rng.standard_normal((3, 2, 4, 4, 4)).astype(np.float32)
                           for _ in range(3))
    sigma = np.asarray([0.05, 1.3, 90.0], np.float32)
    ref = jax_loss.edm_denoising_loss(jnp.asarray(pred), jnp.asarray(noisy), jnp.asarray(target),
                                      jnp.asarray(sigma))
    out = edm_denoising_loss(t(pred), t(noisy), t(target), t(sigma))
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6)
    out_bf16 = edm_denoising_loss(t(pred).bfloat16(), t(noisy), t(target), t(sigma))
    assert out_bf16.dtype == torch.float32  # the loss is f32 whatever the prediction's dtype


@pytest.mark.parametrize("prob", [0.1, 0.3])
def test_conditioning_dropout_matches_jax(prob):
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((16, 1, 8)).astype(np.float32)
    cond = rng.standard_normal((16, 2, 3, 3, 4)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    emb_ref, cond_ref = jax_loss.conditioning_dropout(key, jnp.asarray(emb), jnp.asarray(cond), prob)
    rp = np.asarray(jax.random.uniform(key, (16,)))
    emb_out, cond_out = conditioning_dropout(t(emb), t(cond), prob, rp=t(rp))
    np.testing.assert_allclose(emb_out.numpy(), np.asarray(emb_ref), atol=1e-6)
    np.testing.assert_allclose(cond_out.numpy(), np.asarray(cond_ref), atol=1e-6)
    dropped = (np.abs(np.asarray(emb_ref)).sum((1, 2)) == 0).sum()
    assert 0 < dropped < 16  # both branches were taken


# --------------------------------------------------------------------- optimizer


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a/kernel": rng.standard_normal((5, 7)).astype(np.float32),
            "a/bias": rng.standard_normal((7,)).astype(np.float32),
            "b/scale": (1 + 0.1 * rng.standard_normal((3, 2, 4))).astype(np.float32)}


def _grad_seq(n, seed, scale):
    rng = np.random.default_rng(seed)
    return [{k: (scale * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in _tree(0).items()} for _ in range(n)]


def _run_optax(tx, params, grads_seq):
    params = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(params)
    update = jax.jit(tx.update)
    trail = []
    for g in grads_seq:
        updates, state = update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, updates)
        trail.append({k: np.asarray(v) for k, v in params.items()})
    return trail, state


def _run_port(tx, params, grads_seq):
    params = {k: t(v.copy()) for k, v in params.items()}
    state = tx.init(params)
    trail = []
    for g in grads_seq:
        state = tx.update({k: t(v) for k, v in g.items()}, state, params)
        trail.append({k: v.numpy().copy() for k, v in params.items()})
    return trail, state


def _assert_trails_match(trail, ref, atol=1e-6):
    assert len(trail) == len(ref)
    for step, (a, b) in enumerate(zip(trail, ref)):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], atol=atol, rtol=0, err_msg=f"step {step} {k}")


@pytest.mark.parametrize(
    "kwargs,grad_scale",
    [
        (dict(), 0.01),  # global norm below 1: the clip passes the gradient
        (dict(), 3.0),  # clip active
        (dict(mu_dtype="bfloat16"), 0.01),
        (dict(mu_dtype="bfloat16", max_grad_norm=0.1), 3.0),
        (dict(lr_scheduler="cosine", lr_warmup_steps=3, max_train_steps=10), 1.0),
        (dict(lr_scheduler="linear", lr_warmup_steps=2, max_train_steps=6), 1.0),
        (dict(lr_scheduler="linear", max_train_steps=5), 1.0),  # no warm-up
        (dict(lr_scheduler="constant", lr_warmup_steps=4), 1.0),
        (dict(adam_weight_decay=0.3, adam_beta1=0.8, adam_beta2=0.95, adam_epsilon=1e-3), 1.0),
    ],
    ids=["clip-off", "clip-on", "bf16-mu", "bf16-mu-clip", "cosine", "linear", "linear-nowarm",
         "constant-warmup", "hyper"],
)
def test_adamw_matches_optax(kwargs, grad_scale):
    kw = dict(learning_rate=1e-2, nan_guard_steps=0, **kwargs)
    grads = _grad_seq(7, 1, grad_scale)
    ref, ref_state = _run_optax(jax_make_optimizer(**kw), _tree(0), grads)
    out, state = _run_port(make_optimizer(**kw), _tree(0), grads)
    _assert_trails_match(out, ref)
    assert np.abs(ref[-1]["a/kernel"] - _tree(0)["a/kernel"]).max() > 1e-3  # it did move
    if kwargs.get("mu_dtype"):
        assert state["mu"]["a/kernel"].dtype == torch.bfloat16
        assert state["nu"]["a/kernel"].dtype == torch.float32
        mu_ref = np.asarray(ref_state[1][0].mu["a/kernel"].astype(jnp.float32))
        np.testing.assert_array_equal(state["mu"]["a/kernel"].float().numpy(), mu_ref)


@pytest.mark.parametrize(
    "kwargs,grad_scale,k",
    [(dict(mu_dtype="bfloat16"), 0.01, 1), (dict(mu_dtype="bfloat16"), 3.0, 1), (dict(), 1.0, 1),
     (dict(mu_dtype="bfloat16"), 1.0, 2)],
    ids=["clip-off", "clip-on", "param-dtype-mu", "accumulate-2"],
)
def test_adamw_on_a_bf16_tree_tracks_optax(kwargs, grad_scale, k):
    """bf16 parameters, gradients and both moments for 8 micro-steps. Moments
    within 4 bf16 ulps (3e-2 relative to the tensor's largest element),
    parameters within 2 ulps of a value below 2 (2**-6), their change within
    1e-1 relative L2 of the reference's, and most elements equal to the bit.
    Measured: moments 2.1e-2, parameters 2**-6, change 5.4e-2, 85 % equal."""
    kw = dict(learning_rate=1e-2, nan_guard_steps=0, **kwargs)
    jtx, ptx = jax_make_optimizer(**kw), make_optimizer(**kw)
    if k > 1:
        jtx, ptx = optax.MultiSteps(jtx, every_k_schedule=k), MultiSteps(ptx, k)
    as_f32 = lambda x: np.asarray(x.astype(jnp.float32))  # noqa: E731
    start = {name: t(v.copy()).bfloat16() for name, v in _tree(0).items()}
    ref = {name: jnp.asarray(v.float().numpy(), jnp.bfloat16) for name, v in start.items()}
    params = {name: v.clone() for name, v in start.items()}
    ref_state, state = jtx.init(ref), ptx.init(params)
    update = jax.jit(jtx.update)
    for g in _grad_seq(8, 1, grad_scale):
        updates, ref_state = update({n: jnp.asarray(v, jnp.bfloat16) for n, v in g.items()},
                                    ref_state, ref)
        ref = optax.apply_updates(ref, updates)
        state = ptx.update({n: t(v).bfloat16() for n, v in g.items()}, state, params)
    adam_ref = (ref_state.inner_opt_state if k > 1 else ref_state)[1][0]
    adam = state["inner"] if k > 1 else state
    num = den = equal = total = 0.0
    for name, p in params.items():
        assert p.dtype == adam["mu"][name].dtype == adam["nu"][name].dtype == torch.bfloat16
        for got, want in ((adam["mu"][name], adam_ref.mu[name]), (adam["nu"][name], adam_ref.nu[name])):
            want = as_f32(want)
            assert np.abs(got.float().numpy() - want).max() <= 3e-2 * np.abs(want).max(), name
        got, want, first = p.float().numpy(), as_f32(ref[name]), start[name].float().numpy()
        np.testing.assert_allclose(got, want, atol=2.0**-6, rtol=0, err_msg=name)
        num += ((got - want) ** 2).sum()
        den += ((want - first) ** 2).sum()
        equal += (got == want).sum()
        total += got.size
    assert den > 0 and (num / den) ** 0.5 <= 1e-1, (num / den) ** 0.5
    assert equal >= 0.8 * total, (equal, total)


@pytest.mark.parametrize("name,warmup,total", [("cosine", 3, 10), ("linear", 2, 6),
                                               ("constant", 4, None), ("constant", 0, None)])
def test_schedules_match_optax(name, warmup, total):
    from ctrlv_tpu.train import state as jax_state  # noqa: F401  (the schedules are built inline)

    port = make_schedule(1e-2, name, warmup, total)
    if name == "cosine":
        ref = optax.warmup_cosine_decay_schedule(0.0, 1e-2, warmup, total)
    elif name == "linear":
        ref = optax.join_schedules([optax.linear_schedule(0.0, 1e-2, warmup),
                                    optax.linear_schedule(1e-2, 0.0, total - warmup)], [warmup])
    elif warmup:
        ref = optax.linear_schedule(0.0, 1e-2, warmup)
    else:
        ref = lambda count: 1e-2  # noqa: E731
    for count in range(14):
        np.testing.assert_allclose(port(count), float(ref(count)), rtol=1e-6, atol=1e-9)


def test_accumulation_matches_optax_multisteps():
    """k = 5: the mean of five micro-gradients, one inner update on the fifth,
    and no movement between: not the full-split bench's update every micro-step."""
    kw = dict(learning_rate=1e-2, nan_guard_steps=0, mu_dtype="bfloat16")
    grads = _grad_seq(12, 2, 1.0)
    ref, _ = _run_optax(optax.MultiSteps(jax_make_optimizer(**kw), every_k_schedule=5),
                        _tree(0), grads)
    out, state = _run_port(MultiSteps(make_optimizer(**kw), 5), _tree(0), grads)
    _assert_trails_match(out, ref)
    start = _tree(0)
    for i in range(12):
        moved = np.abs(out[i]["a/bias"] - (out[i - 1] if i else start)["a/bias"]).max() > 0
        assert moved == (i in (4, 9)), i
    assert (state["mini_step"], state["gradient_step"], state["inner"]["count"]) == (2, 2, 2)


def test_nonfinite_step_is_skipped_like_apply_if_finite():
    kw = dict(learning_rate=1e-2, nan_guard_steps=2)
    grads = _grad_seq(7, 3, 1.0)
    grads[2]["a/bias"][3] = np.nan
    grads[5]["b/scale"][0, 0, 0] = np.inf
    ref, ref_state = _run_optax(jax_make_optimizer(**kw), _tree(0), grads)
    out, state = _run_port(make_optimizer(**kw), _tree(0), grads)
    _assert_trails_match(out, ref)
    for k in out[2]:
        np.testing.assert_array_equal(out[2][k], out[1][k])  # the NaN step moved nothing
    assert state["total_notfinite"] == int(ref_state.total_notfinite) == 2
    assert state["notfinite_count"] == int(ref_state.notfinite_count) == 0
    assert state["inner"]["count"] == 5
    # more consecutive bad steps than the guard allows: the next one is let through
    bad = _grad_seq(4, 4, 1.0)
    for g in bad:
        g["a/bias"][0] = np.nan
    ref, _ = _run_optax(jax_make_optimizer(**kw), _tree(0), bad)
    out, state = _run_port(make_optimizer(**kw), _tree(0), bad)
    assert state["notfinite_count"] == 4 and state["inner"]["count"] == 2
    for k in ref[-1]:  # the NaN norm poisons every parameter on both sides
        np.testing.assert_array_equal(np.isnan(out[-1][k]), np.isnan(ref[-1][k]))


# --------------------------------------------------------------------- models and the step


@pytest.fixture(scope="module")
def jax_models():
    """The micro UNet and ControlNet, the tiny VAE and CLIP, with seeded params."""
    ucfg, vcfg, ccfg = JaxUNetConfig.micro(), JaxVAEConfig.tiny(), JaxCLIPConfig.tiny()
    m = dict(unet=JaxUNet(config=ucfg), ctrl=JaxControlNet(config=ucfg), vae=JaxVAE(config=vcfg),
             clip=JaxCLIP(config=ccfg))
    h, w = H // vcfg.spatial_scale, W // vcfg.spatial_scale
    sample, cond = jnp.zeros((1, F, h, w, 8)), jnp.zeros((1, F, h, w, 4))
    enc, tids, ts = jnp.zeros((1, 1, ucfg.cross_attention_dim)), jnp.zeros((1, 3)), jnp.asarray(0.5)
    m["unet_params"] = seeded_params(m["unet"], 20, sample, ts, enc, tids)
    m["ctrl_params"] = seeded_params(m["ctrl"], 21, sample, ts, enc, tids, cond)
    m["vae_params"] = seeded_params(m["vae"], 22, jnp.zeros((1, H, W, 3)))
    m["clip_params"] = seeded_params(m["clip"], 23,
                                     jnp.zeros((1, ccfg.image_size, ccfg.image_size, 3)))
    return m


def port_models(m, **ctrl_kwargs):
    return dict(
        unet=load(UNetSpatioTemporalConditionModel(UNetSTConfig.micro(), **ctrl_kwargs),
                  m["unet_params"]),
        ctrl=load(ControlNetSpatioTemporal(UNetSTConfig.micro(), **ctrl_kwargs), m["ctrl_params"]),
        vae=load(AutoencoderKLTemporalDecoder(VAEConfig.tiny()), m["vae_params"]),
        clip=load(CLIPVisionModelWithProjection(CLIPVisionConfig.tiny()), m["clip_params"],
                  "image_encoder"),
    )


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(5)
    return (rng.uniform(-1, 1, (B, F, H, W, 3)).astype(np.float32),
            rng.uniform(-1, 1, (B, F, H, W, 3)).astype(np.float32))


def jax_step_draws(key):
    """The draws the JAX step makes from ``key`` with ``encode_chunk=None``:
    the five-way split of the step, then the two-way split of the encode."""
    scale = VAEConfig.tiny().spatial_scale
    lat = (H // scale, W // scale, 4)
    rng_enc, rng_sigma, rng_noise, rng_drop, rng_cond = jax.random.split(key, 5)
    rng_lat, rng_init = jax.random.split(rng_enc)
    return {
        "latent_noise": np.asarray(jax.random.normal(rng_lat, (B * F,) + lat, jnp.float32)),
        "init_noise": np.asarray(jax.random.normal(rng_init, (B,) + lat, jnp.float32)),
        "cond_noise": np.asarray(jax.random.normal(rng_cond, (B * F,) + lat, jnp.float32)),
        "sigma_idx": np.asarray(jax.random.randint(rng_sigma, (B,), 0, 1000)),
        "noise": np.asarray(jax.random.normal(rng_noise, (B, F) + lat, jnp.float32)),
        "dropout_u": np.asarray(jax.random.uniform(rng_drop, (B,))),
    }


def test_sampled_vae_encode_matches_jax(jax_models, batch):
    frames = batch[0].reshape(B * F, H, W, 3)
    key = jax.random.PRNGKey(2)
    vae = jax_models["vae"]
    ref = vae.apply(jax_models["vae_params"], jnp.asarray(frames), key, True, method=vae.encode)
    moments_ref = vae.apply(jax_models["vae_params"], jnp.asarray(frames),
                            method=vae.encode_moments)
    noise = np.asarray(jax.random.normal(key, ref.shape, jnp.float32))
    port = port_models(jax_models)["vae"]
    with torch.no_grad():
        moments = port.encode_moments(t(frames))
        out = port.encode(t(frames), noise=t(noise), sample=True)
        mode = port.encode(t(frames))
        chunked = _vae_encode_frames(port, t(frames), t(noise), None, 3)  # 3 -> 2, a divisor of 4
        drawn = port.encode(t(frames), generator=torch.Generator().manual_seed(1), sample=True)
    np.testing.assert_allclose(moments.numpy(), np.asarray(moments_ref), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(mode.numpy(), np.asarray(moments_ref)[..., :4], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(chunked.numpy(), out.numpy(), atol=1e-6)
    assert drawn.shape == out.shape and not torch.allclose(drawn, mode)


class KeepGradients:
    """``inner``, with the last micro-step's gradients kept beside its state."""

    def __init__(self, inner):
        self.inner = inner

    def init(self, params):
        return {"inner": self.inner.init(params), "grads": None}

    def update(self, grads, state, params):
        return {"grads": {k: g.clone() for k, g in grads.items()},
                "inner": self.inner.update(grads, state["inner"], params)}


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_controlnet_train_step_matches_jax(jax_models, batch):
    """Loss and gradients of one micro-step, and the parameters after two
    AdamW updates at accumulation 2, from the same weights and draws."""
    m = jax_models
    clips, bbox = batch
    opt_kw = dict(learning_rate=1e-5, nan_guard_steps=0, mu_dtype="bfloat16")
    real = optax.MultiSteps(jax_make_optimizer(**opt_kw), every_k_schedule=2)

    # one transformation, one jit: the real optimizer, with the micro-step's
    # gradients kept beside its state so that the test can read them
    def update(grads, state, params=None):
        updates, inner = real.update(grads, state[0], params)
        return updates, (inner, grads)

    tx = optax.GradientTransformation(
        lambda p: (real.init(p), jax.tree.map(jnp.zeros_like, p)), update)
    jstep = jax.jit(jax_make_step(m["unet"], m["ctrl"], m["vae"], m["clip"], tx,
                                  conditioning_dropout_prob=DROPOUT))
    jstate = jax_init_state(m["ctrl_params"], tx)

    port = port_models(m)
    ptx = KeepGradients(MultiSteps(make_optimizer(**opt_kw), 2))
    pstep = make_controlnet_train_step(port["unet"], port["ctrl"], port["vae"], port["clip"], ptx,
                                       conditioning_dropout_prob=DROPOUT, device="cpu")
    pstate = init_train_state(port["ctrl"], ptx)
    assert all(not p.requires_grad for p in port["unet"].parameters())
    frozen_before = {k: v.clone() for k, v in port["unet"].state_dict().items()}
    start = {k: v.detach().clone() for k, v in pstate.params.items()}
    initial = start

    dropped = set()
    for i in range(4):
        key = jax.random.PRNGKey(100 + i)
        draws = jax_step_draws(key)
        dropped.add(bool(draws["dropout_u"].min() < 2 * DROPOUT))
        jstate, jmetrics = jstep(jstate, m["unet_params"], m["vae_params"], m["clip_params"],
                                 jnp.asarray(clips), jnp.asarray(bbox), key)
        pstate, pmetrics = pstep(pstate, t(clips), t(bbox),
                                 draws={k: t(v) for k, v in draws.items()})
        loss_ref, loss = float(jmetrics["loss"]), pmetrics["loss"].item()
        assert np.isfinite(loss) and abs(loss - loss_ref) <= 1e-4 * abs(loss_ref), (i, loss, loss_ref)
        np.testing.assert_allclose(pmetrics["grad_norm"].item(), float(jmetrics["grad_norm"]),
                                   rtol=1e-3)
        ref_grads = flax_to_state_dict(flat(jstate.opt_state[1]))
        got = pstate.opt_state["grads"]
        assert set(got) == set(ref_grads)
        num = sum(float(((got[k] - ref_grads[k]) ** 2).sum()) for k in got)
        den = sum(float((ref_grads[k] ** 2).sum()) for k in got)
        assert (num / den) ** 0.5 <= 1e-3, (i, (num / den) ** 0.5)
        for k in ("controlnet_mid_block.weight", "controlnet_down_blocks.0.weight",
                  "control_conv_in.weight"):
            assert _rel_l2(got[k].numpy(), ref_grads[k].numpy()) <= 1e-3, k
        moved = any(not torch.equal(p.detach(), start[k]) for k, p in pstate.params.items())
        assert moved == (i in (1, 3)), i  # only the second micro-step of an update moves them
        start = {k: v.detach().clone() for k, v in pstate.params.items()}
    assert True in dropped  # some micro-step dropped a context
    assert pstate.step == 4 and pstate.opt_state["inner"]["gradient_step"] == 2

    ref_params = flax_to_state_dict(flat(jstate.params))
    num = den = 0.0
    for k, p in pstate.params.items():
        np.testing.assert_allclose(p.detach().numpy(), ref_params[k].numpy(), atol=1e-5, rtol=0,
                                   err_msg=k)
        # the change itself: an element moves by at most 2 lr, as much as atol allows
        moved_ref = (ref_params[k] - initial[k]).double()
        num += float(((p.detach() - initial[k]).double() - moved_ref).square().sum())
        den += float(moved_ref.square().sum())
    assert den > 0 and (num / den) ** 0.5 <= CHANGE_TOL, (num / den) ** 0.5
    for k, v in port["unet"].state_dict().items():
        assert torch.equal(v, frozen_before[k]), k


@pytest.mark.parametrize("granularity", ["block", "sub"])
def test_checkpointing_gives_the_same_gradients(jax_models, batch, granularity):
    """Checkpointed blocks re-run their forward in the backward pass and give
    the gradients of the plain run."""
    draws = {k: t(v) for k, v in jax_step_draws(jax.random.PRNGKey(7)).items()}
    results = []
    for kwargs in (dict(), dict(gradient_checkpointing=True, remat_granularity=granularity)):
        port = port_models(jax_models, **kwargs)
        tx = make_optimizer(learning_rate=1e-3, nan_guard_steps=0)
        step = make_controlnet_train_step(port["unet"], port["ctrl"], port["vae"], port["clip"],
                                          tx, encode_chunk=3, device="cpu")
        state = init_train_state(port["ctrl"], tx)
        state, metrics = step(state, t(batch[0]), t(batch[1]), draws=draws)
        results.append((metrics, {k: p.detach().clone() for k, p in state.params.items()}))
    (m0, p0), (m1, p1) = results
    assert m0["loss"].item() == pytest.approx(m1["loss"].item(), rel=1e-6)
    assert m0["grad_norm"].item() == pytest.approx(m1["grad_norm"].item(), rel=1e-5)
    for k in p0:
        torch.testing.assert_close(p1[k], p0[k], atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        ControlNetSpatioTemporal(UNetSTConfig.micro(), gradient_checkpointing=True,
                                 remat_granularity="layer")


def test_step_draws_from_its_generator_and_checks_its_arguments(jax_models, batch):
    port = port_models(jax_models)
    tx = make_optimizer(learning_rate=0.0, adam_weight_decay=0.0, nan_guard_steps=0)
    step = make_controlnet_train_step(port["unet"], port["ctrl"], port["vae"], port["clip"], tx,
                                      generate_bbox=True, device="cpu")
    clips, bbox = t(batch[0]), t(batch[1])

    def loss(seed):
        state = init_train_state(port["ctrl"], tx)
        return step(state, clips, bbox, generator=torch.Generator().manual_seed(seed))[1]["loss"]

    assert loss(1).item() == loss(1).item() != loss(2).item()
    with pytest.raises(ValueError):
        step(init_train_state(port["ctrl"], tx), clips, bbox, draws={"sigma": 0})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # no card, and the CPU was not asked for
            make_controlnet_train_step(port["unet"], port["ctrl"], port["vae"], port["clip"], tx)
