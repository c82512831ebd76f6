"""Training of the port: the stage-1 (SVD), ControlNet (Box2Video) and
VAE-decoder steps, their loss, the trainable subsets, LoRA, EMA and the
optimizers with f32 master weights (``MasterWeights``); diffusers
checkpoints in (``hf_import.load_hf_component``) and out
(``hf_export.save_pipeline``); training-state checkpoints
(``checkpoints.CheckpointManager``) and the trainers' tracking and in-loop
validation (``observability``). The command lines are in
``ctrlv_tpu_torch.tools``."""

from .checkpoints import CheckpointManager
from .ema import EMAState, ema_init, ema_update
from .hf_export import save_component, save_pipeline
from .hf_import import load_hf_component, load_safetensors
from .lora import LORA_TARGETS, apply_lora, lora_applied, lora_init, merge_lora
from .loss import conditioning_dropout, edm_denoising_loss, sample_training_sigmas
from .state import (
    Adafactor,
    AdamW,
    ApplyIfFinite,
    Masked,
    MasterWeights,
    MultiSteps,
    ScheduledFreeze,
    TrainState,
    global_norm,
    init_train_state,
    make_optimizer,
    make_schedule,
    merge_trainable,
    split_trainable,
    temporal_blocks_predicate,
    trainable_mask,
    vae_decoder_predicate,
)
from .train_step import (
    make_controlnet_train_step,
    make_svd_train_step,
    make_vae_decoder_train_step,
)
