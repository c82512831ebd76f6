"""Box2Video requests: ``StableVideoControlPipeline.__call__`` on one first
frame and its bbox clip, ControlNet and UNet every Euler step under CFG, the
chunked temporal decode."""

from __future__ import annotations

import torch

from .. import traffic as gen
from ..reference import sampling
from .serving import SamplingCell


class Cell(SamplingCell):
    models = ("unet", "controlnet", "vae", "clip")

    def pipeline(self):
        from ctrlv_tpu_torch.pipelines import StableVideoControlPipeline

        n = self.nets
        return StableVideoControlPipeline(n["unet"], n["controlnet"], n["vae"], n["clip"],
                                          device=self.device)

    def request(self, index: int) -> dict:
        t = self.traffic
        image, bbox, noise, latents = self.inputs(index, 1)
        frames = self.pipe(image, bbox, image_noise=noise, latents=latents,
                           num_frames=t["frames"], num_inference_steps=t["steps"],
                           min_guidance_scale=t["guidance"][0], max_guidance_scale=t["guidance"][1],
                           fps=t["fps"], motion_bucket_id=t["motion_bucket_id"],
                           noise_aug_strength=t["noise_aug"], decode_chunk_size=t["decode_chunk"])
        return {"frames": frames}

    def denoise(self, refs, lat_in, t, cond):
        down, mid = refs["controlnet"](lat_in, t, cond["clip"], cond["time_ids"],
                                       cond["control"].float())
        return refs["unet"](lat_in, t, cond["clip"], cond["time_ids"], down, mid)

    def encodes(self, models, image, bbox, noise):
        t = self.traffic
        vae = models["vae"]
        img = vae.encode(image + t["noise_aug"] * noise)
        img = img[:, None].expand(1, t["frames"], *img.shape[1:])
        cond = vae.encode(bbox[0])
        return torch.cat([img.flatten(), cond.flatten()])[None]

    def compare(self, refs, ctls, cap, r):
        t = self.traffic
        image, bbox, noise, _ = self.inputs(r, 1)

        def lazy(fn):
            return (lambda: fn(ctls)) if ctls is not None else None

        def clip_rows(m):
            return self.with_negative(m["clip"](image))

        def encodes(m):
            return self.with_negative(self.encodes(m, image, bbox, noise))

        yield "clip_err", cap.cond["clip"][:, 0], clip_rows(refs), lazy(clip_rows)
        prog = torch.cat([cap.cond["image_latents"].float().reshape(2, -1),
                          cap.cond["control"].float().reshape(2, -1)], dim=1)
        yield "encode_err", prog, encodes(refs), lazy(encodes)
        ramp = sampling.guidance_ramp(t["frames"], torch.tensor([t["guidance"]],
                                                                 device=self.device))
        steps = gen.pick(self.seed, 2 + r, t["steps"] - 1, t["check"]["steps"])
        for s, v_prog, v_ref, (lat_in, ts, cond) in self.step_values(refs, cap, steps, ramp, 1):
            yield ("step_err", v_prog, v_ref,
                   lazy(lambda m: sampling.guided(self.denoise(m, lat_in, ts, cond), ramp)))
        prog, ref = self.decode_values(refs, cap, 0, 1)
        yield "decode_err", prog, ref, lazy(lambda m: self.decode_values(m, cap, 0, 1)[1])
