"""The training steps of the three workloads.

Counterpart of ``ctrlv_tpu/train/train_step.py``:

- ``make_svd_train_step``: the stage-1 (SVD) finetune or, with
  ``predict_bbox``, the bounding-box predictor: CLIP-embed the first RGB
  frame, VAE-encode the clip (the bbox clip with ``predict_bbox``, sampling
  the latent distribution), latent-substitution conditioning, EDM noising,
  conditioning dropout, the UNet, the EDM loss and one optimizer call. Three
  regimes by what ``state.params`` holds: every UNet parameter (full
  finetune, or a masked optimizer over the full set), a subset of them
  (``partitioned``: gradients and moments exist for the subset only), or
  LoRA adapters beside a frozen UNet (``lora``);
- ``make_controlnet_train_step``: the same with the ControlNet's residuals
  into the frozen UNet and the ControlNet's parameters trained;
- ``make_vae_decoder_train_step``: image MSE through the frozen encoder and
  the decoder.

The modules hold their own weights, so a step takes the batch only. The VAE
and CLIP of the diffusion steps run without a graph. In the ControlNet step
the UNet's weights ask for no gradient but its graph is live, because the
ControlNet's gradient passes through its up blocks (the residuals join the
skip connections and the mid block's output). Every random quantity can be
injected through ``draws``. The JAX package's ``make_svd_grad_step`` and
``make_update_step`` split one step into two compiled programs for a
compile-size limit that does not exist here; they have no counterpart.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from ..diffusion.scheduler import training_sigma_table
from ..models.clip_vision import clip_preprocess
from ..pipelines.common import check_generator, resolve_device
from .loss import conditioning_dropout, edm_denoising_loss, sample_training_sigmas
from .lora import lora_applied
from .state import TrainState, global_norm, vae_decoder_predicate

DRAWS = ("latent_noise", "init_noise", "cond_noise", "sigma_idx", "noise", "dropout_u")
# the SVD step: ``rgb_init_noise`` samples the RGB first frame's latent with
# ``predict_bbox``, ``init_noise`` the clip's own first frame without it
SVD_DRAWS = ("latent_noise", "init_noise", "rgb_init_noise", "sigma_idx", "noise", "dropout_u")
VAE_DRAWS = ("noise",)


def _parse_draws(draws, names, device) -> dict:
    draws = dict(draws or {})
    unknown = set(draws) - set(names)
    if unknown:
        raise ValueError(f"draws has unknown keys {sorted(unknown)}")
    return {k: None if draws.get(k) is None else torch.as_tensor(draws[k]).to(device)
            for k in names}


def _gradients(loss, params) -> dict:
    """d loss / d params by name. A parameter the loss does not reach (the
    query and key of a one-token cross-attention) gets zeros, as jax.grad
    gives it."""
    names = list(params)
    return dict(zip(names, torch.autograd.grad(
        loss, [params[k] for k in names], allow_unused=True, materialize_grads=True)))


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


def _make_noise_and_condition(device, dropout_prob, fps, motion_bucket_id, noise_aug_strength):
    """What the diffusion steps share after the encodes: the sigma draw, EDM
    noising and input scaling, conditioning dropout, the micro-conditioning
    ids and the UNet's input (noisy latents and conditioning on the channel
    axis). Returns (sigma, timesteps, noisy, model_in, clip_emb, add_time_ids)."""
    sigma_table = torch.from_numpy(training_sigma_table()).to(device)

    def noise_and_condition(target_latents, clip_emb, cond_latents, draw, generator):
        b = target_latents.shape[0]
        sigma, timesteps = sample_training_sigmas(
            b, sigma_table, generator, device, idx=draw["sigma_idx"])
        noise = draw["noise"]
        if noise is None:
            noise = torch.randn(target_latents.shape, generator=generator, device=device,
                                dtype=torch.float32)
        sigma5 = sigma[:, None, None, None, None]
        noisy = target_latents + noise.float() * sigma5
        inp = noisy / torch.sqrt(sigma5**2 + 1.0)
        if dropout_prob:
            clip_emb, cond_latents = conditioning_dropout(
                clip_emb, cond_latents, dropout_prob, generator, rp=draw["dropout_u"])
        add_time_ids = torch.tensor(
            [[fps - 1, motion_bucket_id, noise_aug_strength]], dtype=torch.float32,
            device=device).repeat(b, 1)
        model_in = torch.cat([inp, cond_latents.to(inp.dtype)], dim=-1)
        return sigma, timesteps, noisy, model_in, clip_emb, add_time_ids

    return noise_and_condition


def _build_conditioning(latents_unscaled, init_latent, predict_bbox: bool,
                        num_cond_bbox_frames: int):
    """Latent-substitution conditioning: the first frame's latent on every
    frame or, with ``predict_bbox``, the bbox latents on the first
    ``num_cond_bbox_frames`` frames and the last one and the first frame's
    latent on the frames between."""
    b, f = latents_unscaled.shape[:2]
    mid = init_latent[:, None].expand((b, f) + init_latent.shape[1:])
    if not predict_bbox:
        return mid
    frame_idx = torch.arange(f, device=latents_unscaled.device)[None, :, None, None, None]
    is_mid = (frame_idx >= num_cond_bbox_frames) & (frame_idx < f - 1)
    return torch.where(is_mid, mid.to(latents_unscaled.dtype), latents_unscaled)


def make_svd_train_step(
    unet,
    vae,
    clip_model,
    tx,
    *,
    predict_bbox: bool = False,
    num_cond_bbox_frames: int = 3,
    conditioning_dropout_prob: Optional[float] = 0.1,
    fps: int = 7,
    motion_bucket_id: int = 127,
    noise_aug_strength: float = 0.02,
    scaling_factor: float = 0.18215,
    lora: bool = False,
    partitioned: bool = False,
    encode_chunk: Optional[int] = None,
    device=None,
) -> Callable:
    """Stage-1 training. ``state.params`` decides the regime:

    - neither flag: every parameter of ``unet`` (``init_train_state(unet,
      tx)``), the full finetune; a masked optimizer may still freeze some;
    - ``partitioned``: a subset of the UNet's own parameters
      (``split_trainable(unet, predicate)``). Only they are asked for a
      gradient, so gradients and moments exist for the subset only; the
      update equals the masked optimizer's over the full set;
    - ``lora``: the adapters of ``lora_init``; the UNet is frozen and computes
      with W + (A B)^T.

    Returns ``step(state, clips, bbox_clips, generator=None, draws=None) ->
    (state, {"loss", "grad_norm"})`` for clips (B, F, H, W, 3) in [-1, 1],
    parameters updated in place. With ``predict_bbox`` the bbox clip is the
    target, and the first RGB frame gives the CLIP embedding and the latent of
    the middle frames. ``draws`` may hold any of ``SVD_DRAWS``:
    ``latent_noise`` (B*F, h, w, 4) for the clip's VAE sampling, ``init_noise``
    (B, h, w, 4) for the first frame's without ``predict_bbox`` and
    ``rgb_init_noise`` with it, ``sigma_idx`` (B,), ``noise`` (B, F, h, w, 4)
    and ``dropout_u`` (B,); what it lacks is drawn from ``generator``.

    ``device=None`` means the card and raises where there is none. The VAE
    and CLIP are put in eval mode and asked for no gradient.
    """
    if lora and partitioned:
        raise ValueError("lora and partitioned are two regimes: choose one")
    device = resolve_device(device)
    for frozen in (vae, clip_model):
        frozen.to(device).eval().requires_grad_(False)
    unet.to(device)
    noise_and_condition = _make_noise_and_condition(
        device, conditioning_dropout_prob, fps, motion_bucket_id, noise_aug_strength)

    def set_regime(params) -> None:
        """Ask exactly the trained UNet parameters for a gradient."""
        own = {id(p): name for name, p in unet.named_parameters()}
        if lora:
            if any(id(p) in own for p in params.values()):
                raise ValueError("lora: state.params must be the adapters, not UNet parameters")
            unet.requires_grad_(False)
            return
        if any(id(p) not in own for p in params.values()):
            raise ValueError("state.params must hold the UNet's own parameters")
        if not partitioned and len(params) != len(own):
            raise ValueError(f"{len(params)} of the UNet's {len(own)} parameters are in "
                             f"state.params: pass partitioned=True for a subset")
        live = {id(p) for p in params.values()}
        for p in unet.parameters():
            p.requires_grad_(id(p) in live)

    def step(state: TrainState, clips, bbox_clips, generator=None, draws=None):
        check_generator(generator, device)
        draw = _parse_draws(draws, SVD_DRAWS, device)
        set_regime(state.params)
        clips, bbox_clips = clips.to(device), bbox_clips.to(device)
        frames = bbox_clips if predict_bbox else clips
        b, f = frames.shape[:2]

        with torch.no_grad():
            flat = frames.reshape((b * f,) + frames.shape[2:])
            latents = _vae_encode_frames(vae, flat, draw["latent_noise"], generator, encode_chunk)
            target_latents = latents.reshape((b, f) + latents.shape[1:]) * scaling_factor
            # the first RGB frame in both modes: without predict_bbox it is the clip's own
            first = clips[:, 0]
            init_latent = vae.encode(
                first, noise=draw["rgb_init_noise" if predict_bbox else "init_noise"],
                generator=generator, sample=True)
            pixel = clip_preprocess(first, image_size=clip_model.config.image_size)
            clip_emb = clip_model(pixel)[:, None, :]
            cond_latents = _build_conditioning(
                target_latents / scaling_factor, init_latent, predict_bbox, num_cond_bbox_frames)
            sigma, timesteps, noisy, model_in, clip_emb, add_time_ids = noise_and_condition(
                target_latents, clip_emb, cond_latents, draw, generator)

        # the adapters stay applied through the backward pass: a checkpointed
        # block runs its forward again there
        applied = lora_applied(unet, state.params) if lora else contextlib.nullcontext()
        with applied, torch.enable_grad():
            pred = unet(model_in, timesteps, clip_emb, add_time_ids)
            loss = edm_denoising_loss(pred, noisy, target_latents, sigma)
            grads = _gradients(loss, state.params)
        grad_norm = global_norm(grads)
        state.opt_state = tx.update(grads, state.opt_state, state.params)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return step


def make_vae_decoder_train_step(vae, tx, device=None) -> Callable:
    """VAE-decoder finetune with the image MSE. ``state.params`` are the
    decoder's parameters alone (``split_trainable(vae,
    vae_decoder_predicate)``): gradients and moments exist only for them, and
    the update equals that of the JAX package's optimizer masked to the
    decoder over the whole VAE. The encoder runs without a graph.

    Returns ``step(state, frames, generator=None, draws=None) -> (state,
    {"loss"})`` for frames (B, F, H, W, 3) in [-1, 1]; ``draws["noise"]``
    (B*F, h, w, 4) is the latent sampling's standard-normal draw.
    """
    device = resolve_device(device)
    vae.to(device)
    decoder = {id(p) for name, p in vae.named_parameters() if vae_decoder_predicate(name)}

    def step(state: TrainState, frames, generator=None, draws=None):
        check_generator(generator, device)
        draw = _parse_draws(draws, VAE_DRAWS, device)
        if any(id(p) not in decoder for p in state.params.values()):
            raise ValueError("state.params must hold parameters of the VAE's decoder only: "
                             "split_trainable(vae, vae_decoder_predicate)")
        frames = frames.to(device)
        b, f = frames.shape[:2]
        flat = frames.reshape((b * f,) + frames.shape[2:])
        with torch.no_grad():
            z = vae.encode(flat, noise=draw["noise"], generator=generator, sample=True)
        with torch.enable_grad():
            recon = vae.decode(z, f)
            loss = torch.mean((recon.float() - flat.float()) ** 2)
            grads = _gradients(loss, state.params)
        state.opt_state = tx.update(grads, state.opt_state, state.params)
        state.step += 1
        return state, {"loss": loss.detach()}

    return step


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
    noise_and_condition = _make_noise_and_condition(
        device, conditioning_dropout_prob, fps, motion_bucket_id, noise_aug_strength)

    def step(state: TrainState, clips, bbox_clips, generator=None, draws=None):
        check_generator(generator, device)
        draw = _parse_draws(draws, DRAWS, device)
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

            sigma, timesteps, noisy, model_in, clip_emb, add_time_ids = noise_and_condition(
                target_latents, clip_emb, image_latents, draw, generator)

        with torch.enable_grad():
            down_res, mid_res = controlnet(model_in, timesteps, clip_emb, add_time_ids,
                                           control_cond)
            pred = unet(model_in, timesteps, clip_emb, add_time_ids,
                        down_block_additional_residuals=down_res,
                        mid_block_additional_residuals=mid_res)
            loss = edm_denoising_loss(pred, noisy, target_latents, sigma)
        grads = _gradients(loss, state.params)
        grad_norm = global_norm(grads)
        state.opt_state = tx.update(grads, state.opt_state, state.params)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return step
