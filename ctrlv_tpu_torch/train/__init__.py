"""Training of the port: the ControlNet (Box2Video) step, its loss and its
optimizer. The SVD and VAE-decoder steps, the masks, LoRA, EMA and
checkpoints of ``ctrlv_tpu/train`` are not ported yet."""

from .loss import conditioning_dropout, edm_denoising_loss, sample_training_sigmas
from .state import (
    AdamW,
    ApplyIfFinite,
    MultiSteps,
    TrainState,
    global_norm,
    init_train_state,
    make_optimizer,
    make_schedule,
)
from .train_step import make_controlnet_train_step
