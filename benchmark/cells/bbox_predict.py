"""Stage-1 requests of the overall pipeline: ``VideoDiffusionPipeline.__call__``
over every guidance pair of the traffic in one batch (frames-major UNet,
bbox latent substitution), then the darkness cleanup and the clip mask IoU
select, as ``OverallPipeline`` calls them."""

from __future__ import annotations

import torch

from .. import traffic as gen
from ..reference import sampling
from .serving import SamplingCell


class Cell(SamplingCell):
    models = ("unet", "vae", "clip")

    @property
    def n(self) -> int:
        return len(self.traffic["guidance_pairs"])

    @property
    def batch(self) -> int:
        return self.n

    def pipeline(self):
        from ctrlv_tpu_torch.pipelines import VideoDiffusionPipeline

        return VideoDiffusionPipeline(self.nets["unet"], self.nets["vae"], self.nets["clip"],
                                      device=self.device)

    def request(self, index: int) -> dict:
        from ctrlv_tpu_torch.metrics.iou import binary_mask_iou_batch
        from ctrlv_tpu_torch.pipelines.overall import darkness_cleanup

        t, n = self.traffic, self.n
        image, bbox, noise, latents = self.inputs(index, n)
        cands = self.pipe(image.repeat(n, 1, 1, 1), bbox_images=bbox.repeat(n, 1, 1, 1, 1),
                          guidance_minmax=torch.tensor(t["guidance_pairs"], dtype=torch.float32),
                          image_noise=noise, latents=latents, num_frames=t["frames"],
                          num_inference_steps=t["steps"], fps=t["fps"],
                          motion_bucket_id=t["motion_bucket_id"], noise_aug_strength=t["noise_aug"],
                          num_cond_bbox_frames=t["num_cond_bbox_frames"],
                          decode_chunk_size=t["decode_chunk"])
        cleaned = darkness_cleanup(cands)
        gt_u8 = torch.floor(torch.clamp(bbox[0] / 2.0 + 0.5, 0.0, 1.0) * 255.0)
        scores = binary_mask_iou_batch(gt_u8, torch.floor(cleaned * 255.0)).cpu()
        best = n - 1 - int(torch.argmax(scores.flip(0)[:, 0]))
        return {"frames": cands, "best": best, "scores": scores}

    def denoise(self, refs, lat_in, t, cond):
        return refs["unet"](lat_in, t, cond["clip"], cond["time_ids"])

    def conditioning(self, models, image, bbox, noise):
        """The image latents with the bbox latents substituted at the first
        ``num_cond_bbox_frames`` frames and the last one, (N, F, h, w, 4)."""
        t, n = self.traffic, self.n
        vae = models["vae"]
        img = vae.encode(image.expand(n, *image.shape[1:]) + t["noise_aug"] * noise)
        lat = img[:, None].repeat(1, t["frames"], 1, 1, 1)
        cond = vae.encode(bbox[0])
        k = t["num_cond_bbox_frames"]
        lat[:, :k] = cond[None, :k]
        lat[:, -1] = cond[None, -1]
        return lat

    def compare(self, refs, ctls, cap, r):
        t, n = self.traffic, self.n
        image, bbox, noise, _ = self.inputs(r, n)

        def lazy(fn):
            return (lambda: fn(ctls)) if ctls is not None else None

        def clip_rows(m):
            return self.with_negative(m["clip"](image).expand(n, -1))

        def encodes(m):
            return self.with_negative(self.conditioning(m, image, bbox, noise))

        yield "clip_err", cap.cond["clip"][:, 0], clip_rows(refs), lazy(clip_rows)
        yield "encode_err", cap.cond["image_latents"].float(), encodes(refs), lazy(encodes)
        ramp = sampling.guidance_ramp(t["frames"], torch.tensor(t["guidance_pairs"],
                                                                 device=self.device))
        steps = gen.pick(self.seed, 2 + r, t["steps"] - 1, t["check"]["steps"])
        for s, v_prog, v_ref, (lat_in, ts, cond) in self.step_values(refs, cap, steps, ramp, n):
            yield ("step_err", v_prog, v_ref,
                   lazy(lambda m: sampling.guided(self.denoise(m, lat_in, ts, cond), ramp)))
        clip = gen.pick(self.seed, 3 + r, n, 1)[0]
        prog, ref = self.decode_values(refs, cap, clip, n)
        yield "decode_err", prog, ref, lazy(lambda m: self.decode_values(m, cap, clip, n)[1])

    def exact_checks(self, picked) -> dict:
        """The select, recomputed from the program's own candidates: how many
        of the requests drawn chose another candidate than the reference."""
        wrong = 0
        for r in picked:
            _, bbox, _, _ = self.inputs(r, 1)
            out = self.captures[r].output
            best, _ = sampling.select(out["frames"], bbox[0])
            wrong += best != out["best"]
        return {"select_mismatch": float(wrong)}
