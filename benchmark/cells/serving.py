"""What the two sampling cells share: the program's models with the
benchmark's weights, the capture of what the timed path produced, and the
comparison of it with the plain reference once the window has closed.

The capture is taken by forward hooks on the program's UNet (its input at
every denoise step, and at the first step its conditioning) and ControlNet
(its control latents at the first step), by a wrapper around the VAE's
``decode`` (every call's float32 latents, before the VAE's own cast), and
by keeping each request's output. It stores no more than a few tensors a
step and does not wait for the device.

The comparison follows the program step by step from its own state: at
each step drawn from the seed, and at the last one (to sigma 0, whose
result is what the decode is given), the reference computes the guided
v-prediction from the program's latents and conditioning, with the
micro-conditioning (``time_ids``) of its own, and the program's is the one
its Euler step implies (``sampling.implied_v``), so the denoiser, the
guidance and the scheduler are judged together. The stages that this skips
are judged by themselves on the request's own inputs: the CLIP embedding
and the VAE encodes (and the latents built from them), each over the whole
guidance batch against the reference's own, whose unconditional half is
zeros; the micro-conditioning rows, exactly; and the decode of the
program's final latents. Each number but the exact ones is a relative L2
error against the reference, with a limit from the traffic file.
"""

from __future__ import annotations

import dataclasses
import gc
from typing import Dict, List

import torch

from .. import traffic as gen
from ..reference import sampling, svd, weights

WARM_UP = 1 << 30  # the index of the warm-up request, which no timed request has

MODEL_CLASSES = {
    "unet": svd.UNetSpatioTemporal,
    "controlnet": svd.ControlNetSpatioTemporal,
    "vae": svd.AutoencoderKLTemporalDecoder,
    "clip": svd.CLIPVisionModelWithProjection,
}


def rel(a, b) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-300))


def reference_model(name: str, config: dict, device="meta") -> torch.nn.Module:
    key = "unet" if name == "controlnet" else name
    with torch.device(device):
        return MODEL_CLASSES[name](config[key])


def port_model(name: str, config: dict, **net_kw):
    """The program's model of ``name``, built on ``meta`` from the configuration;
    ``net_kw`` goes to the UNet's and the ControlNet's constructor."""
    from ctrlv_tpu_torch.models import (AutoencoderKLTemporalDecoder, CLIPVisionConfig,
                                        CLIPVisionModelWithProjection, ControlNetSpatioTemporal,
                                        UNetSpatioTemporalConditionModel, UNetSTConfig,
                                        VAEConfig)

    def fields(cls, src):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in src.items()
                      if k in names})

    layout = config.get("temporal_layout", "seq")
    with torch.device("meta"):
        if name == "unet":
            return UNetSpatioTemporalConditionModel(fields(UNetSTConfig, config["unet"]),
                                                    temporal_layout=layout, **net_kw)
        if name == "controlnet":
            return ControlNetSpatioTemporal(fields(UNetSTConfig, config["unet"]),
                                            temporal_layout=layout, **net_kw)
        if name == "vae":
            return AutoencoderKLTemporalDecoder(fields(VAEConfig, config["vae"]))
        return CLIPVisionModelWithProjection(fields(CLIPVisionConfig, config["clip"]))


@torch.no_grad()
def hand_weights(model: torch.nn.Module, views: Dict[str, torch.Tensor]) -> torch.nn.Module:
    """Give the program's ``model`` (on ``meta``) the benchmark's weights, name
    for name: each parameter becomes a parameter over the benchmark's tensor."""
    names = {n for n, _ in model.named_parameters()}
    if names != set(views):
        raise ValueError(f"the program's parameters differ from the reference's: "
                         f"{sorted(names ^ set(views))[:6]}")
    for mod_name, mod in model.named_modules():
        for pname, p in list(mod._parameters.items()):
            if p is not None:
                full = f"{mod_name}.{pname}" if mod_name else pname
                mod._parameters[pname] = torch.nn.Parameter(views[full], requires_grad=False)
    return model.eval()


@dataclasses.dataclass
class Capture:
    """What the timed path of one request produced."""

    latents: List[torch.Tensor] = dataclasses.field(default_factory=list)  # x_s / sqrt(s^2+1)
    cond: dict = dataclasses.field(default_factory=dict)  # the first step's conditioning
    decoder: List[tuple] = dataclasses.field(default_factory=list)  # (latents / sf, frames) a call
    output: object = None


class SamplingCell:
    """One of the sampling cells. Subclasses set ``models`` (the program's
    models this cell builds) and implement ``pipeline``, ``request``,
    ``denoise`` (the reference's prediction) and ``compare``."""

    models = ("unet", "vae", "clip")

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.dtype = getattr(torch, config["dtype"])
        self.captures: List[Capture] = []
        self._current = None
        self._hooks = []

    # ---- the program ----

    def build(self) -> None:
        self.nets = {}
        for name in self.models:
            ref = reference_model(name, self.config)
            views = weights.make_weights(ref, weights.model_seed(self.seed, name), self.device,
                                         self.dtype)
            self.nets[name] = hand_weights(port_model(name, self.config), views)
        self.pipe = self.pipeline()
        self._hooks = [
            self.nets["unet"].register_forward_pre_hook(self._on_unet, with_kwargs=True),
        ]
        vae = self.nets["vae"]
        decode = vae.decode

        def on_decode(z, num_frames=1):
            if self._current is not None:
                self._current.decoder.append((z.detach().float().clone(), int(num_frames)))
            return decode(z, num_frames)

        vae.decode = on_decode
        if "controlnet" in self.nets:
            self._hooks.append(self.nets["controlnet"].register_forward_pre_hook(self._on_control))

    def _on_unet(self, mod, args, kwargs):
        cap = self._current
        if cap is None:
            return
        lat_in = args[0]
        b = lat_in.shape[0] // 2
        if not cap.latents:
            cap.cond.update(image_latents=lat_in[..., 4:].detach().clone(),
                            clip=args[2].detach().float().clone(),
                            time_ids=args[3].detach().clone())
        cap.latents.append(lat_in[b:, ..., :4].detach().float().clone())

    def _on_control(self, mod, args):
        cap = self._current
        if cap is not None and "control" not in cap.cond:
            cap.cond["control"] = args[4].detach().clone()

    def unit(self, index: int, keep: bool = True) -> bool:
        """Run request ``index`` through the timed path and wait for it.
        Returns whether its output is finite."""
        cap = Capture() if keep else None
        self._current = cap
        try:
            out = self.request(index)
        finally:
            self._current = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if keep:
            cap.output = out
            self.captures.append(cap)
        return bool(torch.isfinite(out["frames"]).all())

    def warm_up(self) -> None:
        """One request at the cell's shapes with the fewest steps that run
        every kernel of a full one."""
        steps = self.traffic["steps"]
        self.traffic["steps"] = self.traffic.get("warmup_steps", 2)
        try:
            self.unit(WARM_UP, keep=False)
        finally:
            self.traffic["steps"] = steps

    def free(self) -> None:
        """Drop the program's models and whatever the check does not read."""
        for h in self._hooks:
            h.remove()
        self._hooks = []
        self.pipe = None
        self.nets = {}
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def span_modules(self):
        """(module, span name) pairs of the program to put spans around."""
        from ctrlv_tpu_torch.models.layers import Attention, FeedForward

        out = [(self.nets["unet"], "unet"), (self.nets["vae"].encoder, "vae_encode"),
               (self.nets["vae"].decoder, "vae_decode"), (self.nets["clip"], "clip")]
        if "controlnet" in self.nets:
            out.append((self.nets["controlnet"], "controlnet"))
        for net in self.nets.values():
            out += [(m, "attention") for m in net.modules() if isinstance(m, Attention)]
            out += [(m, "feed_forward") for m in net.modules() if isinstance(m, FeedForward)]
        return out

    # ---- the reference ----

    def inputs(self, index: int, batch: int):
        t = self.traffic
        image, bbox = gen.bbox_clip(self.seed, index, t["frames"], t["height"], t["width"],
                                    t["boxes"], self.device)
        scale = 2 ** (len(self.config["vae"]["block_out_channels"]) - 1)
        noise, latents = gen.noises(self.seed, index, batch, t["frames"], t["height"],
                                    t["width"], scale, self.config["vae"]["latent_channels"],
                                    self.device)
        return image, bbox, noise, latents

    def reference_models(self, names) -> dict:
        out = {}
        for name in names:
            ref = reference_model(name, self.config)
            views = weights.make_weights(ref, weights.model_seed(self.seed, name), self.device,
                                         self.dtype)
            out[name] = weights.load_reference(ref, views, self.device)
            del views
        return out

    def sigmas(self):
        return sampling.karras_sigmas(self.traffic["steps"]).to(self.device)

    def time_ids(self, rows: int):
        """The micro-conditioning rows (fps - 1, motion bucket, noise
        augmentation) of the traffic, float32."""
        t = self.traffic
        return torch.tensor([[t["fps"] - 1, t["motion_bucket_id"], t["noise_aug"]]],
                            device=self.device).repeat(rows, 1)

    def final_latents(self, cap: Capture, batch: int):
        """The latents the program decoded, (B, F, h, w, c): every decode
        call's input times the scaling factor, in frame order."""
        parts = [z.reshape(batch, z.shape[0] // batch, *z.shape[1:]) for z, _ in cap.decoder]
        return torch.cat(parts, dim=1) * self.config["vae"]["scaling_factor"]

    def step_values(self, refs: dict, cap: Capture, steps: List[int], ramp, batch: int):
        """[(step, program's implied v, reference's guided v, the reference's
        input)] at the steps drawn and at the last step."""
        sig = self.sigmas()
        last = len(sig) - 2
        cond = dict(cap.cond, time_ids=self.time_ids(cap.cond["time_ids"].shape[0]))
        out = []
        for s in sorted(set(steps) | {last}):
            x = cap.latents[s] * torch.sqrt(sig[s] ** 2 + 1.0)
            x_next = (self.final_latents(cap, batch) if s == last
                      else cap.latents[s + 1] * torch.sqrt(sig[s + 1] ** 2 + 1.0))
            v_prog = sampling.implied_v(x, x_next, sig[s], sig[s + 1])
            lat_in = torch.cat([sampling.scale_input(torch.cat([x, x]), sig[s]),
                                cap.cond["image_latents"].float()], dim=-1)
            t = sampling.c_noise(sig[s])
            out.append((s, v_prog, sampling.guided(self.denoise(refs, lat_in, t, cond), ramp),
                        (lat_in, t, cond)))
        return out

    def decode_values(self, refs: dict, cap: Capture, clip: int, batch: int):
        """(the program's frames of clip ``clip``, the reference's decode of the
        program's latents of that clip)."""
        frames = []
        for z, nf in cap.decoder:
            per = z.shape[0] // batch
            zc = z.reshape(batch, per, *z.shape[1:])[clip]
            frames.append(torch.clamp(refs["vae"].decode(zc, nf) / 2.0 + 0.5, 0.0, 1.0))
        return cap.output["frames"][clip].float(), torch.cat(frames)

    @staticmethod
    def with_negative(x):
        """The whole guidance batch of a conditioning: zeros, then ``x``."""
        return torch.cat([torch.zeros_like(x), x])

    def check(self, control: bool = False) -> list:
        """[(name, program's reading, control's or None, limit)] over the
        requests drawn from the seed among those finished; the control's
        readings only with ``control``."""
        t = self.traffic
        limits = t["limits"]
        chk = t["check"]
        picked = gen.pick(self.seed, 1, len(self.captures), chk["requests"])
        worst: Dict[str, float] = {}
        worst_ctl: Dict[str, float] = {}
        names = list(self.models)
        refs = self.reference_models(names)
        ctls = None
        if control:
            ctls = self.reference_models(names)
            for m in ctls.values():
                sampling.emulate_fp8(m)
        with torch.no_grad():
            for r in picked:
                cap = self.captures[r]
                for name, prog, ref, ctl_fn in self.compare(refs, ctls, cap, r):
                    worst[name] = max(worst.get(name, 0.0), rel(prog, ref))
                    if ctl_fn is not None:
                        worst_ctl[name] = max(worst_ctl.get(name, 0.0), rel(ctl_fn(), ref))
        for name, value in self.exact_checks(picked).items():
            worst[name] = value
        ids = [self.captures[r].cond["time_ids"].float() for r in picked]
        worst["time_ids_err"] = max(float((i - self.time_ids(i.shape[0])).abs().max()) for i in ids)
        return [(k, worst[k], worst_ctl.get(k), limits[k]) for k in worst]

    def exact_checks(self, picked) -> dict:
        return {}

    # ---- the yardstick's counts ----

    batch = 1  # clips a request samples

    def decode_calls(self, batch: int) -> list:
        """(frames, frames a clip) of each decoder call of a request: the full
        chunks in one call, the rest in another."""
        t = self.traffic
        full, rest = divmod(t["frames"], t["decode_chunk"])
        return ([(batch * full * t["decode_chunk"], t["decode_chunk"])] if full else []) + (
            [(batch * rest, rest)] if rest else [])

    def work(self):
        """(FLOPs, attention and feed-forward sites) of one request, counted on
        the reference models on ``meta``: CLIP, the two VAE encodes, every
        denoise step at the CFG batch, the decode calls."""
        from .. import yardstick

        refs = {name: reference_model(name, self.config) for name in self.models}
        t, b = self.traffic, self.batch
        f, height, width = t["frames"], t["height"], t["width"]
        vae = self.config["vae"]
        scale = 2 ** (len(vae["block_out_channels"]) - 1)
        h, w, c = height // scale, width // scale, vae["latent_channels"]
        unet = self.config["unet"]
        clips = [b]

        def z(*shape):
            return torch.zeros(shape, device="meta")

        def request():
            clips[0] = b
            refs["clip"](z(b, height, width, 3))
            refs["vae"].encode(z(b, height, width, 3))
            refs["vae"].encode(z(b * f, height, width, 3))
            clips[0] = 2 * b
            cond = {"clip": z(2 * b, 1, unet["cross_attention_dim"]), "time_ids": z(2 * b, 3),
                    "control": z(2 * b, f, h, w, c)}
            for _ in range(t["steps"]):
                self.denoise(refs, z(2 * b, f, h, w, unet["in_channels"]), z(), cond)
            for frames, nf in self.decode_calls(b):
                refs["vae"].decode(z(frames, h, w, c), nf)

        with torch.no_grad():
            return yardstick.count(request, refs, lambda: clips[0])
