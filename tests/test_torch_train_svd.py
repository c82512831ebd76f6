"""The port's stage-1 (SVD) and VAE-decoder training steps against the JAX
package's.

The micro UNet and the tiny VAE and CLIP of tests/test_torch_train.py, f32 on
the CPU, from the same converted weights. The JAX step's own ``jax.random``
draws are made here from the same key and handed to the port through
``draws``. Three regimes of the SVD step: the full finetune, the temporal
blocks alone (``partitioned``, the bbox predictor of stage 1) and LoRA.

Tolerances, as for the ControlNet step: the loss to 1e-4 relative and the
gradients to 1e-3 relative L2 (CLIP, two VAE encodes and the UNet forward and
backward, each side with its own order of f32 sums); parameters after two
AdamW updates at accumulation 2 and lr 1e-5 to 1e-5 absolute, and their change
to ``CHANGE_TOL`` relative L2 of the reference's change; what a regime freezes
stays bit-identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ctrlv_tpu.train import lora as jax_lora
from ctrlv_tpu.train import make_svd_train_step as jax_make_svd_step
from ctrlv_tpu.train import make_vae_decoder_train_step as jax_make_vae_step
from ctrlv_tpu.train import train_step as jax_train_step
from ctrlv_tpu.train.state import init_train_state as jax_init_state
from ctrlv_tpu.train.state import make_optimizer as jax_make_optimizer
from ctrlv_tpu.train.state import split_trainable as jax_split_trainable
from ctrlv_tpu.train.state import temporal_blocks_predicate as jax_temporal_predicate
from ctrlv_tpu.train.state import trainable_mask as jax_trainable_mask
from ctrlv_tpu_torch.convert import flax_to_state_dict
from ctrlv_tpu_torch.models import VAEConfig
from ctrlv_tpu_torch.train import (
    MultiSteps,
    init_train_state,
    lora_init,
    make_optimizer,
    make_svd_train_step,
    make_vae_decoder_train_step,
    split_trainable,
    temporal_blocks_predicate,
    trainable_mask,
    vae_decoder_predicate,
)
from ctrlv_tpu_torch.train.train_step import _build_conditioning
from test_torch_convert import flat
from test_torch_train import KeepGradients, jax_models, port_models, t  # noqa: F401  (fixture)

torch.set_num_threads(1)

B, F, H, W = 2, 4, 16, 16
K_COND = 2  # frames 0 and 1 and the last keep the bbox latents, frame 2 gets the first RGB frame's
DROPOUT = 0.3
OPT = dict(learning_rate=1e-5, nan_guard_steps=0, mu_dtype="bfloat16")
# Two updates move an element by about 2e-5, as much as the absolute bound on
# the parameters allows, so the change itself is held too: f32 resolves it to
# 3e-3 of itself on a weight of order 1, and a bf16 first moment may round the
# other way where the gradients differ by 1e-3.
CHANGE_TOL = 1e-2


def change_rel_l2(params, ref_params, initial) -> float:
    """Relative L2 of (params - initial) against (ref_params - initial), over all names."""
    num = den = 0.0
    for k, p in params.items():
        moved_ref = (ref_params[k] - initial[k]).double()
        num += float(((p.detach() - initial[k]).double() - moved_ref).square().sum())
        den += float(moved_ref.square().sum())
    assert den > 0
    return (num / den) ** 0.5


@pytest.fixture(scope="module")
def clips():
    rng = np.random.default_rng(11)
    return (rng.uniform(-1, 1, (B, F, H, W, 3)).astype(np.float32),
            rng.uniform(-1, 1, (B, F, H, W, 3)).astype(np.float32))


def svd_step_draws(key):
    """The draws the JAX SVD step makes from ``key`` with ``encode_chunk=None``:
    the five-way split of the step, then the two-way split of the encode."""
    scale = VAEConfig.tiny().spatial_scale
    lat = (H // scale, W // scale, 4)
    rng_enc, rng_enc_rgb, rng_sigma, rng_noise, rng_drop = jax.random.split(key, 5)
    rng_lat, rng_init = jax.random.split(rng_enc)
    return {
        "latent_noise": np.asarray(jax.random.normal(rng_lat, (B * F,) + lat, jnp.float32)),
        "init_noise": np.asarray(jax.random.normal(rng_init, (B,) + lat, jnp.float32)),
        "rgb_init_noise": np.asarray(jax.random.normal(rng_enc_rgb, (B,) + lat, jnp.float32)),
        "sigma_idx": np.asarray(jax.random.randint(rng_sigma, (B,), 0, 1000)),
        "noise": np.asarray(jax.random.normal(rng_noise, (B, F) + lat, jnp.float32)),
        "dropout_u": np.asarray(jax.random.uniform(rng_drop, (B,))),
    }


@pytest.mark.parametrize("predict_bbox", [False, True])
@pytest.mark.parametrize("k", [1, 3])
def test_build_conditioning_matches_jax(predict_bbox, k):
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((2, 6, 3, 3, 4)).astype(np.float32)
    init = rng.standard_normal((2, 3, 3, 4)).astype(np.float32)
    want = np.asarray(jax_train_step._build_conditioning(jnp.asarray(lat), jnp.asarray(init),
                                                         predict_bbox, k))
    got = _build_conditioning(t(lat), t(init), predict_bbox, k).numpy()
    np.testing.assert_array_equal(got, want)
    if predict_bbox:  # the bbox latents on the first k frames and the last, the image between
        np.testing.assert_array_equal(got[:, :k], lat[:, :k])
        np.testing.assert_array_equal(got[:, -1], lat[:, -1])
        np.testing.assert_array_equal(got[:, k], init)


def keep_grads(real):
    """``real`` with the micro-step's gradients kept beside its state: one
    transformation, so one jit."""

    def update(grads, state, params=None):
        updates, inner = real.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(
        lambda p: (real.init(p), jax.tree.map(jnp.zeros_like, p)), update)


def jax_lora_tree(unet_params):
    """Adapters with A from the JAX package's own init and a small random B, so
    that both get a gradient from the first micro-step on."""
    lora = jax_lora.lora_init(jax.random.PRNGKey(5), unet_params["params"], rank=2)
    rng = np.random.default_rng(12)
    return {path: {"a": ab["a"],
                   "b": jnp.asarray(0.05 * rng.standard_normal(ab["b"].shape), jnp.float32)}
            for path, ab in lora.items()}


def lora_to_port(tree):
    """{path: {"a", "b"}} -> {"<module>.lora_a": ..., "<module>.lora_b": ...}; the
    adapters keep the JAX shapes (they are no kernels, so nothing is transposed)."""
    return flax_to_state_dict({"/".join(path[:-1]) + f"/lora_{leaf}": np.asarray(ab[leaf])
                               for path, ab in tree.items() for leaf in ("a", "b")})


REGIMES = {
    "full": dict(predict_bbox=False),
    "partitioned": dict(predict_bbox=True, partitioned=True),
    "lora": dict(predict_bbox=True, lora=True),
}


@pytest.mark.parametrize("regime", list(REGIMES))
def test_svd_train_step_matches_jax(jax_models, clips, regime):  # noqa: F811
    """Loss and gradients of each micro-step, and the parameters after two
    AdamW updates at accumulation 2, from the same weights and draws."""
    m = jax_models
    rgb, bbox = clips
    flags = REGIMES[regime]
    kwargs = dict(num_cond_bbox_frames=K_COND, conditioning_dropout_prob=DROPOUT, **flags)
    jtx = keep_grads(optax.MultiSteps(jax_make_optimizer(**OPT), every_k_schedule=2))
    jstep = jax.jit(jax_make_svd_step(m["unet"], m["vae"], m["clip"], jtx, **kwargs))
    port = port_models(m)
    unet = port["unet"]
    ptx = KeepGradients(MultiSteps(make_optimizer(**OPT), 2))
    pstep = make_svd_train_step(unet, port["vae"], port["clip"], ptx, device="cpu", **kwargs)

    if regime == "full":
        jparams, base = m["unet_params"], None
        pstate = init_train_state(unet, ptx)
        to_port = lambda tree: flax_to_state_dict(flat(tree))  # noqa: E731
    elif regime == "partitioned":
        jparams = jax_split_trainable(m["unet_params"], jax_temporal_predicate)
        base = m["unet_params"]
        pstate = init_train_state(split_trainable(unet, temporal_blocks_predicate), ptx)
        to_port = lambda tree: flax_to_state_dict(flat(tree))  # noqa: E731
        assert 0 < len(pstate.params) < len(list(unet.parameters()))
    else:
        jparams, base = jax_lora_tree(m["unet_params"]), m["unet_params"]
        adapters = lora_to_port(jparams)
        lora = lora_init({k: v for k, v in adapters.items() if k.endswith("lora_a")}, unet, rank=2)
        with torch.no_grad():
            for k, v in adapters.items():
                lora[k].copy_(v)
        pstate = init_train_state(lora, ptx)
        to_port = lora_to_port
    jstate = jax_init_state(jparams, jtx)
    assert set(pstate.params) == set(to_port(jparams))

    held = {id(p) for p in pstate.params.values()}
    frozen = {f"{name}.{k}": p.detach().clone()
              for name in ("unet", "vae", "clip") for k, p in port[name].named_parameters()
              if id(p) not in held}
    initial = {k: v.detach().clone() for k, v in pstate.params.items()}
    start = initial
    for i in range(4):
        key = jax.random.PRNGKey(200 + i)
        draws = svd_step_draws(key)
        jstate, jmetrics = jstep(jstate, m["vae_params"], m["clip_params"], jnp.asarray(rgb),
                                 jnp.asarray(bbox), key, base)
        pstate, pmetrics = pstep(pstate, t(rgb), t(bbox), draws={k: t(v) for k, v in draws.items()})
        loss_ref, loss = float(jmetrics["loss"]), pmetrics["loss"].item()
        assert np.isfinite(loss) and abs(loss - loss_ref) <= 1e-4 * abs(loss_ref), (i, loss,
                                                                                    loss_ref)
        np.testing.assert_allclose(pmetrics["grad_norm"].item(), float(jmetrics["grad_norm"]),
                                   rtol=1e-3)
        ref_grads, got = to_port(jstate.opt_state[1]), pstate.opt_state["grads"]
        assert set(got) == set(ref_grads)
        num = sum(float(((got[k] - ref_grads[k]) ** 2).sum()) for k in got)
        den = sum(float((ref_grads[k] ** 2).sum()) for k in got)
        assert den > 0 and (num / den) ** 0.5 <= 1e-3, (i, (num / den) ** 0.5)
        moved = any(not torch.equal(p.detach(), start[k]) for k, p in pstate.params.items())
        assert moved == (i in (1, 3)), i  # only the second micro-step of an update moves them
        start = {k: v.detach().clone() for k, v in pstate.params.items()}
    assert pstate.step == 4 and pstate.opt_state["inner"]["gradient_step"] == 2

    ref_params = to_port(jstate.params)
    changed = 0
    for k, p in pstate.params.items():
        np.testing.assert_allclose(p.detach().numpy(), ref_params[k].numpy(), atol=1e-5, rtol=0,
                                   err_msg=k)
        changed += int(not torch.equal(p.detach(), initial[k]))
    assert changed > len(initial) // 2
    rel = change_rel_l2(pstate.params, ref_params, initial)
    assert rel <= CHANGE_TOL, rel
    for name in ("unet", "vae", "clip"):
        for k, p in port[name].named_parameters():
            if id(p) not in held:
                assert torch.equal(p.detach(), frozen[f"{name}.{k}"]), (name, k)
    if regime == "lora":
        assert not any(p.requires_grad for p in unet.parameters())
        assert all(isinstance(mod.weight, torch.nn.Parameter) for mod in unet.modules()
                   if isinstance(mod, torch.nn.Linear))  # nothing left shadowed
    elif regime == "partitioned":
        assert all(p.requires_grad == temporal_blocks_predicate(k)
                   for k, p in unet.named_parameters())


def test_partitioned_update_equals_the_masked_one(jax_models, clips):  # noqa: F811
    """Gradients and moments for the subset only, or for every parameter under
    a masked optimizer: the trained parameters move alike, the rest not at all."""
    rgb, bbox = t(clips[0]), t(clips[1])
    kw = dict(learning_rate=1e-3, nan_guard_steps=0)
    flags = dict(predict_bbox=True, num_cond_bbox_frames=K_COND, device="cpu")
    results = []
    for partitioned in (True, False):
        port = port_models(jax_models)
        unet = port["unet"]
        before = {k: p.detach().clone() for k, p in unet.named_parameters()}
        if partitioned:
            tx = make_optimizer(**kw)
            state = init_train_state(split_trainable(unet, temporal_blocks_predicate), tx)
        else:
            tx = make_optimizer(mask=trainable_mask(unet, temporal_blocks_predicate), **kw)
            state = init_train_state(unet, tx)
        step = make_svd_train_step(unet, port["vae"], port["clip"], tx, partitioned=partitioned,
                                   **flags)
        metrics = []
        for i in range(2):
            draws = {k: t(v) for k, v in svd_step_draws(jax.random.PRNGKey(300 + i)).items()}
            state, out = step(state, rgb, bbox, draws=draws)
            metrics.append((out["loss"].item(), out["grad_norm"].item()))
        results.append((metrics, {k: p.detach().clone() for k, p in unet.named_parameters()}))
        for k, p in unet.named_parameters():
            assert torch.equal(p.detach(), before[k]) is (not temporal_blocks_predicate(k)), k
    (m_part, p_part), (m_mask, p_mask) = results
    assert m_part[0][0] == pytest.approx(m_mask[0][0], rel=1e-6)
    # the masked step reports the norm over every gradient, the partitioned one over its subset
    assert m_mask[0][1] > m_part[0][1] > 0
    for k in p_part:
        torch.testing.assert_close(p_part[k], p_mask[k], atol=1e-7, rtol=0)


@pytest.mark.parametrize("regime", ["partitioned", "lora"])
def test_checkpointing_gives_the_same_update(jax_models, clips, regime):  # noqa: F811
    """A checkpointed block runs its forward again in the backward pass: the
    trainable subset and the LoRA weights must still be in place then."""
    draws = {k: t(v) for k, v in svd_step_draws(jax.random.PRNGKey(7)).items()}
    results = []
    for kwargs in (dict(), dict(gradient_checkpointing=True)):
        port = port_models(jax_models, **kwargs)
        unet = port["unet"]
        tx = make_optimizer(learning_rate=1e-3, nan_guard_steps=0)
        if regime == "lora":
            params = lora_init(torch.Generator().manual_seed(3), unet, rank=2)
            with torch.no_grad():
                for k, v in params.items():
                    if k.endswith("lora_b"):
                        v.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(4))
        else:
            params = split_trainable(unet, temporal_blocks_predicate)
        step = make_svd_train_step(unet, port["vae"], port["clip"], tx, predict_bbox=True,
                                   num_cond_bbox_frames=K_COND, encode_chunk=3, device="cpu",
                                   **{regime: True})
        state, metrics = step(init_train_state(params, tx), t(clips[0]), t(clips[1]), draws=draws)
        results.append((metrics, {k: p.detach().clone() for k, p in state.params.items()}))
    (m0, p0), (m1, p1) = results
    assert m0["loss"].item() == pytest.approx(m1["loss"].item(), rel=1e-6)
    assert m0["grad_norm"].item() == pytest.approx(m1["grad_norm"].item(), rel=1e-5)
    assert m0["grad_norm"].item() > 0
    for k in p0:
        torch.testing.assert_close(p1[k], p0[k], atol=1e-6, rtol=0)


def test_svd_step_checks_its_arguments(jax_models, clips):  # noqa: F811
    port = port_models(jax_models)
    tx = make_optimizer(learning_rate=0.0, adam_weight_decay=0.0, nan_guard_steps=0)
    rgb, bbox = t(clips[0]), t(clips[1])
    with pytest.raises(ValueError):
        make_svd_train_step(port["unet"], port["vae"], port["clip"], tx, lora=True,
                            partitioned=True, device="cpu")
    step = make_svd_train_step(port["unet"], port["vae"], port["clip"], tx, device="cpu")
    subset = init_train_state(split_trainable(port["unet"], temporal_blocks_predicate), tx)
    with pytest.raises(ValueError, match="partitioned"):
        step(subset, rgb, bbox)
    with pytest.raises(ValueError, match="unknown"):
        step(init_train_state(port["unet"].requires_grad_(True), tx), rgb, bbox,
             draws={"cond_noise": 0})

    def loss(seed):
        state = init_train_state(port["unet"].requires_grad_(True), tx)
        return step(state, rgb, bbox, generator=torch.Generator().manual_seed(seed))[1]["loss"]

    assert loss(1).item() == loss(1).item() != loss(2).item()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # no card, and the CPU was not asked for
            make_svd_train_step(port["unet"], port["vae"], port["clip"], tx)


def test_vae_decoder_train_step_matches_jax(jax_models, clips):  # noqa: F811
    """Image MSE through the frozen encoder and the decoder. The JAX step
    holds the whole VAE under an optimizer masked to the decoder, built on the
    tree under "params" (the package's own predicate looks at the first path
    component); the port's holds the decoder's parameters alone."""
    m = jax_models
    frames = clips[0][:, :2]
    kw = dict(learning_rate=1e-5, nan_guard_steps=0)
    jmask = jax_trainable_mask(m["vae_params"], lambda path: path[1] == "decoder")
    jtx = keep_grads(jax_make_optimizer(mask=jmask, **kw))
    jstep = jax.jit(jax_make_vae_step(m["vae"], jtx))
    jstate = jax_init_state(m["vae_params"], jtx)

    vae = port_models(m)["vae"]
    ptx = KeepGradients(make_optimizer(**kw))
    pstep = make_vae_decoder_train_step(vae, ptx, device="cpu")
    pstate = init_train_state(split_trainable(vae, vae_decoder_predicate), ptx)
    assert 0 < len(pstate.params) < len(list(vae.parameters()))
    assert all(vae_decoder_predicate(k) for k in pstate.params)
    before = {k: p.detach().clone() for k, p in vae.named_parameters()}
    lat = (H // VAEConfig.tiny().spatial_scale, W // VAEConfig.tiny().spatial_scale, 4)
    for i in range(2):
        key = jax.random.PRNGKey(400 + i)
        noise = np.asarray(jax.random.normal(key, (B * 2,) + lat, jnp.float32))
        jstate, jmetrics = jstep(jstate, jnp.asarray(frames), key)
        pstate, pmetrics = pstep(pstate, t(frames), draws={"noise": t(noise)})
        loss_ref, loss = float(jmetrics["loss"]), pmetrics["loss"].item()
        assert abs(loss - loss_ref) <= 1e-4 * abs(loss_ref), (i, loss, loss_ref)
        ref_grads, got = flax_to_state_dict(flat(jstate.opt_state[1])), pstate.opt_state["grads"]
        assert set(got) == set(pstate.params)
        num = sum(float(((got[k] - ref_grads[k]) ** 2).sum()) for k in got)
        den = sum(float((ref_grads[k] ** 2).sum()) for k in got)
        assert den > 0 and (num / den) ** 0.5 <= 1e-3, (i, (num / den) ** 0.5)
        for k in ref_grads:
            if k not in got:  # stop_gradient: the reference's own are zero there
                assert float(ref_grads[k].abs().max()) == 0, k
    ref_params = flax_to_state_dict(flat(jstate.params))
    moved = 0
    for k, p in vae.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref_params[k].numpy(), atol=1e-5, rtol=0,
                                   err_msg=k)
        if vae_decoder_predicate(k):
            moved += int(not torch.equal(p.detach(), before[k]))
        else:
            assert torch.equal(p.detach(), before[k]), k  # encoder and quant_conv untouched
    assert moved > len(pstate.params) // 2
    rel = change_rel_l2(pstate.params, ref_params, before)
    assert rel <= CHANGE_TOL, rel
    # the whole VAE in state.params is refused: the step trains the decoder's subset
    with pytest.raises(ValueError, match="decoder"):
        pstep(init_train_state(dict(vae.named_parameters()), ptx), t(frames))
