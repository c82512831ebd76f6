#!/bin/bash
# The PyTorch port's counterpart of scripts/train_scripts/demo_train_video_box2video.sh:
# the same flags and defaults through ctrlv_tpu_torch.tools.train_video_controlnet.
# Run from the repository's root; it runs on the card (--device cpu for the CPU).
#
# Stage-2 Box2Video ControlNet training — canonical hyperparameters
# (parity with demo_train_video_box2video.sh: lr 1e-5, grad-accum 5,
# guidance 1->3).
python -m ctrlv_tpu_torch.tools.train_video_controlnet \
    --dataset_name bdd100k \
    --data_root ./datasets \
    --learning_rate 1e-5 \
    --gradient_accumulation_steps 5 \
    --train_batch_size 1 \
    --clip_length 25 \
    --min_guidance_scale 1 --max_guidance_scale 3 \
    --noise_aug_strength 0.02 \
    --enable_gradient_checkpointing \
    --checkpointing_steps 500 \
    --output_dir output/box2video "$@"
