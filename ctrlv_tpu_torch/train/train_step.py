"""The ControlNet training step.

Counterpart of ``ctrlv_tpu/train/train_step.py::make_controlnet_train_step``
and its helpers: CLIP-embed the first frame, VAE-encode the clip and the
conditioning clip (sampling the latent distribution), EDM noising,
conditioning dropout, the ControlNet's residuals into the frozen UNet, the
EDM loss, and one optimizer call on the ControlNet's parameters.

The modules hold their own weights, so the step takes the batch only. The
VAE and CLIP run without a graph; the UNet's weights ask for no gradient but
its graph is live, because the ControlNet's gradient passes through its up
blocks (the residuals join the skip connections and the mid block's output). Every random quantity can be injected through ``draws``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..diffusion.scheduler import training_sigma_table
from ..models.clip_vision import clip_preprocess
from ..pipelines.common import check_generator, resolve_device
from .loss import conditioning_dropout, edm_denoising_loss, sample_training_sigmas
from .state import TrainState, global_norm

DRAWS = ("latent_noise", "init_noise", "cond_noise", "sigma_idx", "noise", "dropout_u")


def _vae_encode_frames(vae, flat, noise, generator, chunk):
    """Sampled VAE latents of (N, H, W, 3) frames, in sequential chunks of at
    most ``chunk`` frames: the encoder's full-resolution activations set the
    step's peak memory otherwise. A chunk that does not divide N is reduced
    to the largest divisor of N below it, as in the JAX package. ``noise``
    (N, h, w, 4) is the standard-normal draw, or None to draw it."""
    n_frames = flat.shape[0]
    if not chunk or n_frames <= chunk:
        return vae.encode(flat, noise=noise, generator=generator, sample=True)
    while n_frames % chunk:
        chunk -= 1
    return torch.cat([
        vae.encode(flat[i:i + chunk], noise=None if noise is None else noise[i:i + chunk],
                   generator=generator, sample=True)
        for i in range(0, n_frames, chunk)
    ])


def _encode_batch(vae, clip_model, frames, latent_noise, init_noise, generator, scaling,
                  encode_chunk=None):
    """frames (B, F, H, W, 3) -> (latents * scale, first-frame latent, CLIP embedding)."""
    b, f = frames.shape[:2]
    flat = frames.reshape((b * f,) + frames.shape[2:])
    latents = _vae_encode_frames(vae, flat, latent_noise, generator, encode_chunk)
    latents = latents.reshape((b, f) + latents.shape[1:])
    initial = frames[:, 0]
    init_latent = vae.encode(initial, noise=init_noise, generator=generator, sample=True)
    pixel = clip_preprocess(initial, image_size=clip_model.config.image_size)
    clip_emb = clip_model(pixel)[:, None, :]
    return latents * scaling, init_latent, clip_emb


def make_controlnet_train_step(
    unet,
    controlnet,
    vae,
    clip_model,
    tx,
    *,
    generate_bbox: bool = False,
    conditioning_dropout_prob: Optional[float] = 0.1,
    fps: int = 7,
    motion_bucket_id: int = 127,
    noise_aug_strength: float = 0.02,
    scaling_factor: float = 0.18215,
    encode_chunk: Optional[int] = None,
    device=None,
) -> Callable:
    """ControlNet-only training: ``state.params`` are the ControlNet's
    parameters (``init_train_state(controlnet, tx)``), updated in place.

    Returns ``step(state, clips, bbox_clips, generator=None, draws=None) ->
    (state, {"loss", "grad_norm"})`` for clips (B, F, H, W, 3) in [-1, 1].
    ``generate_bbox`` swaps conditioning and target, to train the inverse.
    ``draws`` may hold any of ``DRAWS``: the standard-normal noises of the
    three VAE samplings (``latent_noise`` and ``cond_noise`` (B*F, h, w, 4),
    ``init_noise`` (B, h, w, 4)), the sigma table indices ``sigma_idx`` (B,),
    the diffusion ``noise`` (B, F, h, w, 4) and the dropout uniforms
    ``dropout_u`` (B,); what it lacks is drawn from ``generator``.

    ``device=None`` means the card and raises where there is none. The
    frozen modules are put in eval mode and asked for no gradient.
    """
    device = resolve_device(device)
    for frozen in (unet, vae, clip_model):
        frozen.to(device).eval().requires_grad_(False)
    controlnet.to(device)
    sigma_table = torch.from_numpy(training_sigma_table()).to(device)

    def step(state: TrainState, clips, bbox_clips, generator=None, draws=None):
        check_generator(generator, device)
        draws = dict(draws or {})
        unknown = set(draws) - set(DRAWS)
        if unknown:
            raise ValueError(f"draws has unknown keys {sorted(unknown)}")
        draw = {k: None if draws.get(k) is None else torch.as_tensor(draws[k]).to(device)
                for k in DRAWS}
        clips, bbox_clips = clips.to(device), bbox_clips.to(device)
        target_frames, cond_frames = (bbox_clips, clips) if generate_bbox else (clips, bbox_clips)
        b, f = target_frames.shape[:2]

        with torch.no_grad():
            latents_scaled, init_latent, clip_emb = _encode_batch(
                vae, clip_model, target_frames, draw["latent_noise"], draw["init_noise"],
                generator, scaling_factor, encode_chunk,
            )
            # the conditioning clip is sampled too, as the reference's training path does
            flat_cond = cond_frames.reshape((b * f,) + cond_frames.shape[2:])
            control_cond = _vae_encode_frames(vae, flat_cond, draw["cond_noise"], generator,
                                              encode_chunk)
            control_cond = control_cond.reshape((b, f) + control_cond.shape[1:])
            image_latents = init_latent[:, None].expand((b, f) + init_latent.shape[1:])
            target_latents = latents_scaled

            sigma, timesteps = sample_training_sigmas(
                b, sigma_table, generator, device, idx=draw["sigma_idx"])
            noise = draw["noise"]
            if noise is None:
                noise = torch.randn(target_latents.shape, generator=generator, device=device,
                                    dtype=torch.float32)
            sigma5 = sigma[:, None, None, None, None]
            noisy = target_latents + noise.float() * sigma5
            inp = noisy / torch.sqrt(sigma5**2 + 1.0)
            if conditioning_dropout_prob:
                clip_emb, image_latents = conditioning_dropout(
                    clip_emb, image_latents, conditioning_dropout_prob, generator,
                    rp=draw["dropout_u"])
            add_time_ids = torch.tensor(
                [[fps - 1, motion_bucket_id, noise_aug_strength]], dtype=torch.float32,
                device=device).repeat(b, 1)
            model_in = torch.cat([inp, image_latents.to(inp.dtype)], dim=-1)

        with torch.enable_grad():
            down_res, mid_res = controlnet(model_in, timesteps, clip_emb, add_time_ids,
                                           control_cond)
            pred = unet(model_in, timesteps, clip_emb, add_time_ids,
                        down_block_additional_residuals=down_res,
                        mid_block_additional_residuals=mid_res)
            loss = edm_denoising_loss(pred, noisy, target_latents, sigma)
        names = list(state.params)
        # a parameter the loss does not reach (the query and key of a one-token
        # cross-attention) gets zeros, as jax.grad gives it
        grads = dict(zip(names, torch.autograd.grad(
            loss, [state.params[k] for k in names], allow_unused=True, materialize_grads=True)))
        grad_norm = global_norm(grads)
        state.opt_state = tx.update(grads, state.opt_state, state.params)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return step
