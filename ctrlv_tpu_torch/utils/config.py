"""The typed config and command line of the port's tools.

Counterpart of ``ctrlv_tpu/utils/config.py``: the same ``Config`` fields,
defaults and checks, and ``parse_args`` with the same flag names (a bool is
``--flag`` / ``--no-flag``), so a command line of the JAX tools runs here as
it is. Two differences: ``compute_dtype`` is a torch dtype, and one flag is
added, ``--device``, the device the tools run on: unset means the card (and
raises where there is none), ``cpu`` is for tests. The JAX package's
mesh and compiler knobs are accepted; the tools raise where one asks for
more than one card.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional


@dataclasses.dataclass
class Config:
    # --- experiment / logging -----------------------------------------
    project_name: str = "ctrlv-tpu"
    run_name: Optional[str] = None
    wandb_entity: Optional[str] = None
    report_to: str = "none"  # wandb not available in this environment by default
    logging_dir: str = "logs"
    output_dir: str = "output"
    seed: int = 0

    # --- data ----------------------------------------------------------
    data_root: str = "./datasets"
    dataset_name: str = "kitti"  # kitti|vkitti|mkitti|bdd100k|davis|nuscenes|synthetic
    clip_length: int = 25
    train_H: int = 320
    train_W: int = 512
    eval_H: Optional[int] = None
    fps: int = 7  # bdd100k default 5 (set in __post_init__)
    dataloader_num_workers: int = 0
    non_overlapping_clips: bool = False
    use_segmentation: bool = False
    if_last_frame_trajectory: bool = False
    use_preplotted_bbox: bool = True

    # --- model ---------------------------------------------------------
    pretrained_model_name_or_path: str = "stabilityai/stable-video-diffusion-img2vid-xt"
    pretrained_bbox_model: Optional[str] = None
    finetuned_svd_path: Optional[str] = None
    revision: Optional[str] = None
    variant: Optional[str] = None
    num_cond_bbox_frames: int = 3
    add_bbox_frame_conditioning: bool = False
    disable_object_condition: bool = False
    encoder_hid_dim_type: Optional[str] = None
    predict_bbox: bool = False
    generate_bbox: bool = False  # train video->bbox inverse ControlNet

    # --- training ------------------------------------------------------
    train_batch_size: int = 1
    num_train_epochs: int = 100
    max_train_steps: Optional[int] = None
    gradient_accumulation_steps: int = 1
    learning_rate: float = 1e-5
    scale_lr: bool = False
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 500
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    mixed_precision: str = "bf16"  # the reference used fp16
    enable_gradient_checkpointing: bool = False
    backprop_temporal_blocks_start_iter: int = -1
    object_net_lr_factor: float = 1.0
    # Accepted for reference-CLI compatibility but intentionally no-ops:
    # the reference parses these too and never reads them anywhere outside
    # utils/parser.py (verified: parser.py:99,213,236 — zero other usages).
    snr_gamma: Optional[float] = None
    noise_offset: float = 0.0
    prediction_type: Optional[str] = None

    # --- regularization / conditioning dropout -------------------------
    conditioning_dropout_prob: Optional[float] = 0.1
    bbox_dropout_prob: float = 0.0
    noise_aug_strength: float = 0.02

    # --- parameter-efficient / EMA ------------------------------------
    enable_lora: bool = False
    rank: int = 4
    use_ema: bool = False
    non_ema_revision: Optional[str] = None

    # --- inference / guidance -----------------------------------------
    num_inference_steps: int = 25
    min_guidance_scale: float = 1.0
    max_guidance_scale: float = 3.0
    guidance_scale: float = 7.5  # legacy image pipeline
    guidance_rescale: float = 0.0  # reference-compat no-op (parser.py:248, unused there)
    conditioning_scale: float = 1.0
    motion_bucket_id: int = 127
    decode_chunk_size: int = 8
    # cap on frames per batched VAE-decode call (None = one batched call);
    # bounds the decode's peak memory (SamplingConfig.max_decode_frames)
    max_decode_frames: Optional[int] = None
    # cap on frames per VAE-encode call inside the training step (None =
    # one batched call); bounds the encoder's full-resolution activations
    vae_encode_chunk: Optional[int] = None

    # --- checkpointing / eval ------------------------------------------
    checkpointing_steps: int = 500
    checkpoints_total_limit: Optional[int] = None
    resume_from_checkpoint: Optional[str] = None
    validation_steps: int = 500
    # validation_prompt / num_validation_images exist only as commented-out
    # dead code in the reference (parser.py:192-203; validation_steps' help
    # text still references them) — carried for flag-surface parity.
    validation_prompt: Optional[str] = None
    num_validation_images: int = 4
    num_demo_samples: int = 4
    evaluate_only: bool = False
    eval_dir: Optional[str] = None
    demo_path: Optional[str] = None

    # --- the JAX package's device knobs (the port runs on one card) -----
    mesh_data: Optional[int] = None  # above 1: multi-card, not ported
    mesh_frame: int = 1  # above 1: multi-card, not ported
    attention_impl: str = "auto"  # auto|xla|pallas
    profile_dir: Optional[str] = None
    optimizer_sharding: str = "auto"  # auto|none|zero1
    optimizer: str = "adamw"  # adamw|adafactor
    adam_mu_dtype: Optional[str] = None  # e.g. bfloat16
    split_train_step: bool = False

    # --- the port -------------------------------------------------------
    device: Optional[str] = None  # None: the card; "cpu" for tests

    def __post_init__(self):
        if self.dataset_name.lower() == "bdd100k" and self.fps == 7:
            self.fps = 5  # reference per-dataset default (parser.py:434-441)
        if self.eval_H is None:
            self.eval_H = self.train_H
        if self.mixed_precision not in ("no", "fp16", "bf16"):
            raise ValueError(
                f"--mixed_precision must be no|fp16|bf16, got {self.mixed_precision!r}"
            )
        if self.attention_impl not in ("auto", "xla", "pallas"):
            raise ValueError(
                f"--attention_impl must be auto|xla|pallas, got {self.attention_impl!r}"
            )
        if self.optimizer_sharding not in ("auto", "none", "zero1"):
            raise ValueError(
                f"--optimizer_sharding must be auto|none|zero1, got "
                f"{self.optimizer_sharding!r}"
            )
        if self.optimizer not in ("adamw", "adafactor"):
            raise ValueError(
                f"--optimizer must be adamw|adafactor, got {self.optimizer!r}"
            )

    @property
    def compute_dtype(self):
        import torch

        return {"no": torch.float32, "fp16": torch.float16, "bf16": torch.bfloat16}[
            self.mixed_precision
        ]


def parse_args(argv=None) -> Config:
    """CLI mirroring the reference's flag names over the typed Config."""
    parser = argparse.ArgumentParser(description="ctrlv_tpu_torch config")
    for field in dataclasses.fields(Config):
        name = "--" + field.name
        default = field.default
        ann = str(field.type)
        if "bool" in ann or isinstance(default, bool):
            # --flag / --no-flag so True-default bools are disable-able from
            # the CLI (reference scripts need e.g. use_preplotted_bbox=False)
            parser.add_argument(
                name, action=argparse.BooleanOptionalAction, default=default
            )
        elif "int" in ann:
            parser.add_argument(name, type=int, default=default)
        elif "float" in ann:
            parser.add_argument(name, type=float, default=default)
        else:
            parser.add_argument(name, type=str, default=default)
    ns = parser.parse_args(argv)
    return Config(**vars(ns))
