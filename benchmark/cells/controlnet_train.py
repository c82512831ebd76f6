"""ControlNet training micro-steps: ``make_controlnet_train_step``'s step with
the trainer's optimizer (AdamW under ``MultiSteps`` accumulation, under f32
master weights of the ControlNet), the UNet, VAE and CLIP frozen, block
checkpointing.

Set-up builds the one step object, drives it through its first update
(``accumulation`` micro-steps, the window's own call and feed, rows that all
differ), and makes the rows of the window's micro-steps on the device, so
that no micro-step waits for the benchmark's synthesis of its inputs. The
window goes on with the same object; its first update is the run's second.

What is read from the program: each micro-step's loss; the gradient that
each of the first two updates applied, as AdamW's first moment holds it
(``mu_1 / (1 - b1)`` after the first, ``(mu_2 - b1 mu_1) / (1 - b1)`` after
the second: the clipped mean of that update's micro-step gradients); and
each master weight's change at the second update. The moments and masters
are copied on the device at the end of set-up and after the second update's
micro-step, inside the window (a few elementwise kernels once a run).

After the window the float32 reference follows the same two updates from
the same weights, clips and draws, with AdamW's state and float32 masters of
its own, computing with the masters rounded to the configuration's dtype as
the trainer's chain states (an update of lr 1e-5 moves most bf16 weights by
less than their rounding step, and every one of 0.68 B weights a little, so
a reference on the unrounded masters reads a loss 4-16 % lower after one
update). The numbers compared are: the largest relative gap of a
micro-step's loss, the relative L2 error over every leaf of each update's
applied gradient, and the relative L2 error of the second update's change
over the leaves that move.
Leaves whose accumulated reference gradient is under a thousandth of the
median leaf's move by round-off alone (the query and key of a one-token
cross-attention) and are left out of the change."""

from __future__ import annotations

import gc
from typing import Dict, List

import torch

from .. import traffic as gen
from ..reference import sampling, training, weights
from .serving import hand_weights, port_model, reference_model

MODELS = ("unet", "controlnet", "vae", "clip")


def rel_l2(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], names) -> float:
    """||prog - ref|| / ||ref|| over the leaves ``names`` together, in float64."""
    diff = norm = 0.0
    for n in names:
        r = ref[n].double()
        diff += float((prog[n].to(r.device).double() - r).square().sum())
        norm += float(r.square().sum())
    return (diff / max(norm, 1e-300)) ** 0.5


def adam_state(opt_state: dict) -> dict:
    """AdamW's state (``count``, ``mu``, ``nu``) inside the optimizer's wrappers."""
    while "mu" not in opt_state:
        opt_state = opt_state["inner"]
    return opt_state


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.dtype = getattr(torch, config["dtype"])
        self.accum = traffic["accumulation"]
        self.updates: List[bool] = []
        self.losses: List[float] = []
        self.readings: dict = {}
        self.rows: dict = {}
        self.first = 0

    def _views(self, name):
        ref = reference_model(name, self.config)
        return ref, weights.make_weights(ref, weights.model_seed(self.seed, name), self.device,
                                         self.dtype)

    def build(self) -> None:
        from ctrlv_tpu_torch.train import (MasterWeights, MultiSteps, init_train_state,
                                           make_controlnet_train_step, make_optimizer)

        t = self.traffic
        self.nets = {}
        for name in MODELS:
            kw = ({"gradient_checkpointing": True, "remat_granularity": t["remat"]}
                  if name in ("unet", "controlnet") else {})
            self.nets[name] = hand_weights(port_model(name, self.config, **kw), self._views(name)[1])
        tx = make_optimizer(learning_rate=t["learning_rate"], adam_beta1=t["adam_beta1"],
                            adam_beta2=t["adam_beta2"], adam_epsilon=t["adam_epsilon"],
                            adam_weight_decay=t["weight_decay"], max_grad_norm=t["max_grad_norm"])
        tx = MasterWeights(MultiSteps(tx, self.accum))
        self.state = init_train_state(self.nets["controlnet"].requires_grad_(True), tx)
        self.names = list(self.state.opt_state["master"])
        self.step = make_controlnet_train_step(
            self.nets["unet"], self.nets["controlnet"], self.nets["vae"], self.nets["clip"], tx,
            conditioning_dropout_prob=t["conditioning_dropout"], fps=t["fps"],
            motion_bucket_id=t["motion_bucket_id"], noise_aug_strength=t["noise_aug"],
            encode_chunk=t["encode_chunk"], device=self.device)

    def inputs(self, row: int):
        """(clip, bbox clip, draws) of micro-step ``row``, made on the device."""
        t = self.traffic
        b, f, height, width = t["clips"], t["frames"], t["height"], t["width"]
        g = torch.Generator(device=self.device).manual_seed(gen.request_seed(self.seed, row, 2))
        clips = 2 * torch.rand((b, f, height, width, 3), generator=g, device=self.device) - 1
        bbox = torch.cat([gen.bbox_clip(self.seed, row * b + i, f, height, width, t["boxes"],
                                        self.device)[1] for i in range(b)])
        vae = self.config["vae"]
        scale = 2 ** (len(vae["block_out_channels"]) - 1)
        lat = (height // scale, width // scale, vae["latent_channels"])

        def randn(*shape, dtype=torch.float32):
            return torch.randn(shape, generator=g, device=self.device, dtype=dtype)

        draws = {"latent_noise": randn(b * f, *lat, dtype=self.dtype),
                 "init_noise": randn(b, *lat, dtype=self.dtype),
                 "cond_noise": randn(b * f, *lat, dtype=self.dtype),
                 "sigma_idx": torch.randint(0, 1000, (b,), generator=g, device=self.device),
                 "noise": randn(b, f, *lat),
                 "dropout_u": torch.rand((b,), generator=g, device=self.device)}
        return clips, bbox, draws

    def _micro_step(self, row: int) -> float:
        clips, bbox, draws = self.rows.pop(row, None) or self.inputs(row)
        _, metrics = self.step(self.state, clips, bbox, draws=draws)
        loss = float(metrics["loss"])
        self.losses.append(loss)
        return loss

    def unit(self, index: int, keep: bool = True) -> bool:
        row = self.first + index
        loss = self._micro_step(row)
        self.updates.append((row + 1) % self.accum == 0)
        if row == 2 * self.accum - 1:
            self._read_second_update()
        return loss == loss and abs(loss) != float("inf")

    def warm_up(self) -> None:
        """The first update through the window's own call; its applied
        gradient; copies of the moments and masters it left; the window's rows."""
        for row in range(self.accum):
            self._micro_step(row)
        adam, masters = adam_state(self.state.opt_state), self.state.opt_state["master"]
        b1 = self.traffic["adam_beta1"]
        self.readings["first_grad"] = dict(zip(self.names, torch._foreach_div(
            [adam["mu"][n].float() for n in self.names], 1.0 - b1)))
        self._mu = [adam["mu"][n].float().clone() for n in self.names]
        self._master = [masters[n].clone() for n in self.names]
        self.first = self.accum
        for row in range(self.accum, self.accum + self.traffic["window_rows"]):
            self.rows[row] = self.inputs(row)

    def _read_second_update(self) -> None:
        """The second update's applied gradient and change, from the copies."""
        adam, masters = adam_state(self.state.opt_state), self.state.opt_state["master"]
        b1 = self.traffic["adam_beta1"]
        torch._foreach_mul_(self._mu, -b1)
        torch._foreach_add_(self._mu, [adam["mu"][n].float() for n in self.names])
        torch._foreach_div_(self._mu, 1.0 - b1)
        torch._foreach_sub_(self._master, [masters[n] for n in self.names])
        torch._foreach_neg_(self._master)
        self.readings["grad"] = dict(zip(self.names, self._mu))
        self.readings["change"] = dict(zip(self.names, self._master))
        self._mu = self._master = None

    def complete(self) -> None:
        """Micro-steps after the window, untimed, until the second update has
        been read (a window too short to reach it)."""
        while "change" not in self.readings:
            self.unit(len(self.updates))

    def free(self) -> None:
        self.step = self.state = None
        self.rows = {}
        self.nets = {}
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def span_modules(self):
        from ctrlv_tpu_torch.models.layers import Attention, FeedForward

        out = [(self.nets["unet"], "unet"), (self.nets["controlnet"], "controlnet"),
               (self.nets["vae"].encoder, "vae_encode"), (self.nets["clip"], "clip")]
        for net in self.nets.values():
            out += [(m, "attention") for m in net.modules() if isinstance(m, Attention)]
            out += [(m, "feed_forward") for m in net.modules() if isinstance(m, FeedForward)]
        return out

    # ---- the reference ----

    def reference_models(self, fp8: bool = False) -> dict:
        out = {}
        for name in MODELS:
            ref, views = self._views(name)
            out[name] = weights.load_reference(ref, views, self.device)
            if fp8:
                sampling.emulate_fp8(out[name])
        for name in ("unet", "controlnet"):
            out[name].checkpoint_blocks = True
        out["controlnet"].requires_grad_(True)
        return out

    def follow(self, fp8: bool = False) -> dict:
        """The reference's (or with ``fp8`` the control's) readings of the
        first two updates: each micro-step's loss, each update's applied
        gradient, the second update's change, the accumulated gradient's
        norm of each leaf at the second update."""
        t = self.traffic
        models = self.reference_models(fp8)
        params = dict(models["controlnet"].named_parameters())
        names = list(params)
        masters = {n: p.detach().clone() for n, p in params.items()}
        adam = training.adamw_init(masters)
        out = {"loss": []}
        for update, key in enumerate(("first_grad", "grad")):
            acc = {n: torch.zeros_like(p) for n, p in params.items()}
            for row in range(update * self.accum, (update + 1) * self.accum):
                clips, bbox, draws = self.inputs(row)
                loss = training.controlnet_loss(models, clips, bbox, draws, t)
                grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True,
                                            materialize_grads=True)
                out["loss"].append(float(loss.detach()))
                torch._foreach_add_([acc[n] for n in names], grads, alpha=1.0 / self.accum)
                del grads, loss
            out["acc_norms"] = dict(zip(names, (float(x) for x in torch.stack(
                torch._foreach_norm([acc[n] for n in names], 2)).cpu())))
            out[key] = training.clip_by_global_norm(acc, t["max_grad_norm"])
            del acc
            change = training.adamw_update(masters, out[key], adam, t)
            with torch.no_grad():  # the weights computed with: the masters in the stated dtype
                for n, p in params.items():
                    p.copy_(masters[n].to(self.dtype))
            if fp8:
                sampling.fp8_weights(models["controlnet"])
        out["change"] = change
        del models, params, masters, adam
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return out

    @staticmethod
    def moved(ref: dict) -> list:
        """The leaves whose accumulated reference gradient reaches a thousandth
        of the median leaf's."""
        norms = sorted(ref["acc_norms"].values())
        floor = 1e-3 * norms[len(norms) // 2]
        return [n for n, v in ref["acc_norms"].items() if v >= floor]

    def compare(self, prog: dict, ref: dict) -> dict:
        """The numbers compared (see the module's docstring)."""
        return {"loss_err": max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])),
                "first_grad_err": rel_l2(prog["first_grad"], ref["first_grad"], ref["first_grad"]),
                "grad_err": rel_l2(prog["grad"], ref["grad"], ref["grad"]),
                "change_err": rel_l2(prog["change"], ref["change"], self.moved(ref))}

    def check(self, control: bool = False) -> list:
        """[(name, program's reading, control's or None, limit)]."""
        ref = self.follow()
        losses = self.losses[:2 * self.accum]
        numbers = self.compare(dict(self.readings, loss=losses), ref)
        self.readings = {}
        _, _, draws = self.inputs(0)
        self.detail = {"losses": {"program": losses, "reference": ref["loss"]},
                       "left_out_of_change": len(ref["acc_norms"]) - len(self.moved(ref)),
                       "first_draws": {"sigma_idx": draws["sigma_idx"].tolist(),
                                       "dropout_u": draws["dropout_u"].tolist()}}
        ctl = self.compare(self.follow(fp8=True), ref) if control else {}
        limits = self.traffic["limits"]
        return [(k, v, ctl.get(k), limits[k]) for k, v in numbers.items()]

    # ---- the yardstick's counts ----

    def work(self):
        """(FLOPs, sites) of one micro-step on the reference models on ``meta``:
        the encodes and CLIP, then the ControlNet and UNet forward and
        backward with the program's block checkpointing, the recompute
        counted."""
        from .. import yardstick

        refs = {name: reference_model(name, self.config).requires_grad_(name == "controlnet")
                for name in MODELS}
        for name in ("unet", "controlnet"):
            refs[name].checkpoint_blocks = True
        t = self.traffic
        b, f = t["clips"], t["frames"]
        vae = self.config["vae"]
        scale = 2 ** (len(vae["block_out_channels"]) - 1)
        lat = (t["height"] // scale, t["width"] // scale, vae["latent_channels"])

        def z(*shape):
            return torch.zeros(shape, device="meta")

        draws = {"latent_noise": z(b * f, *lat), "init_noise": z(b, *lat),
                 "cond_noise": z(b * f, *lat), "noise": z(b, f, *lat),
                 "sigma_idx": torch.zeros(b, dtype=torch.long, device="meta"),
                 "dropout_u": z(b) + 0.9}

        def micro_step():
            with torch.enable_grad():
                loss = training.controlnet_loss(refs, z(b, f, t["height"], t["width"], 3),
                                                z(b, f, t["height"], t["width"], 3), draws, t)
                torch.autograd.backward(loss)

        return yardstick.count(micro_step, refs, lambda: b)
