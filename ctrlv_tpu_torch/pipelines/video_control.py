"""Stage-2 Box2Video pipeline: ControlNet-conditioned SVD generation.

Counterpart of ``ctrlv_tpu/pipelines/video_control.py``. Every denoise step
runs the ControlNet, then the UNet with its down and mid residuals; CFG
uses zeroed negative conditioning for the CLIP, VAE and control latents.
The loop is a Python loop of eager calls.

The pipeline runs on the card: ``device=None`` means "cuda" and raises where
there is none; ``device="cpu"`` is what the CPU tests pass. The constructor
moves the modules there and ``__call__`` moves its inputs there.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from ..diffusion import EulerDiscreteScheduler, euler_step, scale_model_input
from ..parallel.frames import frame_sharded
from .common import (
    SampleShard,
    SamplingConfig,
    check_generator,
    decode_latents,
    default_guidance,
    encode_clip_image,
    encode_vae_image,
    encode_vae_video,
    get_add_time_ids,
    guidance_linspace,
    postprocess_frames,
    resolve_device,
)


class StableVideoControlPipeline:
    def __init__(self, unet, controlnet, vae, image_encoder,
                 scheduler: Optional[EulerDiscreteScheduler] = None,
                 device: Union[str, torch.device, None] = None, mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.unet = unet.to(self.device)
        self.controlnet = controlnet.to(self.device)
        self.vae = vae.to(self.device)
        self.image_encoder = image_encoder.to(self.device)
        self.scheduler = scheduler or EulerDiscreteScheduler()

    @torch.no_grad()
    def __call__(
        self,
        image,  # (B, H, W, 3) in [-1, 1]
        cond_images,  # (B, F, H, W, 3) frames or (B, F, h, w, 4) latents
        generator: Optional[torch.Generator] = None,
        guidance_minmax=None,  # (B, 2)
        output_type: str = "np",
        image_noise=None,  # (B, H, W, 3) standard normal; drawn if None
        latents=None,  # (B, F, h, w, 4) standard normal; drawn if None
        **kwargs,
    ):
        """(B, F, H, W, 3) frames in [0, 1], or the final latents when
        ``output_type == "latent"``.

        ``image_noise`` is the noise-augmentation draw; ``latents`` is the
        initial draw, scaled by ``init_noise_sigma`` here as in diffusers.
        Handing both in reproduces another sampler's draws exactly.
        """
        cfg = SamplingConfig(**kwargs)
        device = self.device
        check_generator(generator, device)
        image, cond_images = image.to(device), cond_images.to(device)
        batch = image.shape[0]
        if guidance_minmax is None:
            guidance_minmax = default_guidance(cfg, batch, device)
        guidance_minmax = guidance_minmax.to(device)
        # As in the reference: the guidance values flow through guidance_minmax
        # and only do_cfg is kept from the config.
        cfg = dataclasses.replace(
            cfg, min_guidance_scale=0.0, max_guidance_scale=2.0 if cfg.do_cfg else 1.0
        )
        do_cfg = cfg.do_cfg
        sched = self.scheduler.set_timesteps(cfg.num_inference_steps, device=device)

        if image_noise is None:
            image_noise = torch.randn(
                image.shape, generator=generator, dtype=image.dtype, device=device
            )
        clip_emb = encode_clip_image(self.image_encoder, image, do_cfg)
        img_latent = encode_vae_image(
            self.vae, image, image_noise.to(device), cfg.noise_aug_strength, do_cfg
        )
        image_latents = img_latent[:, None].repeat(1, cfg.num_frames, 1, 1, 1).float()

        if cond_images.shape[-1] == 4:
            cond_em = cond_images
            if do_cfg:
                cond_em = torch.cat([torch.zeros_like(cond_em), cond_em], dim=0)
        else:
            cond_em = encode_vae_video(self.vae, cond_images, do_cfg)

        add_time_ids = get_add_time_ids(cfg, batch, do_cfg, device)
        h, w = image_latents.shape[2:4]
        shape = (batch, cfg.num_frames, h, w, self.unet.config.out_channels)
        if latents is None:
            latents = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        latents = latents.to(device).float() * sched.init_noise_sigma
        guidance = guidance_linspace(cfg.num_frames, guidance_minmax)

        # on a mesh: this rank's samples and frames of everything the loop reads
        shard = SampleShard(self.mesh, batch, cfg.num_frames, do_cfg)
        latents, guidance = shard.local(latents), shard.local(guidance)
        image_latents = shard.local(image_latents, cfg=True)
        clip_emb = shard.local(clip_emb, cfg=True, frames=False)
        add_time_ids = shard.local(add_time_ids, cfg=True, frames=False)
        cond_em = shard.local(cond_em, cfg=True)

        for i in range(cfg.num_inference_steps if shard.rows else 0):
            sigma, sigma_next = sched.sigmas[i], sched.sigmas[i + 1]
            t = sched.timesteps[i]
            lat_in = torch.cat([latents] * 2) if do_cfg else latents
            lat_in = torch.cat([scale_model_input(lat_in, sigma), image_latents], dim=-1)
            with frame_sharded(shard.frame):
                down_res, mid_res = self.controlnet(
                    lat_in, t, clip_emb, add_time_ids, cond_em,
                    conditioning_scale=cfg.control_condition_scale,
                )
                pred = self.unet(
                    lat_in, t, clip_emb, add_time_ids,
                    down_block_additional_residuals=down_res,
                    mid_block_additional_residuals=mid_res,
                ).float()
            if do_cfg:
                uncond, cond = pred.chunk(2, dim=0)
                pred = uncond + guidance * (cond - uncond)
            latents = euler_step(pred, latents, sigma, sigma_next)
        latents = shard.gather(latents)

        if output_type == "latent":
            return latents
        frames = decode_latents(
            self.vae, latents, self.vae.config.scaling_factor, cfg.decode_chunk_size,
            max_frames_per_call=cfg.max_decode_frames,
        )
        return postprocess_frames(frames).float()
