#!/bin/bash
# The PyTorch port's counterpart of scripts/train_scripts/demo_train_bbox_predict.sh:
# the same flags and defaults through ctrlv_tpu_torch.tools.train_video_diffusion.
# Run from the repository's root; it runs on the card (--device cpu for the CPU).
#
# Stage-1 bbox predictor training — canonical hyperparameters
# (parity with the reference's demo_train_bbox_predict.sh: lr 5e-6,
# grad-accum 5, clip 25, guidance 3->7, noise_aug 0.01, 30 steps).
python -m ctrlv_tpu_torch.tools.train_video_diffusion \
    --dataset_name kitti \
    --data_root ./datasets \
    --predict_bbox \
    --learning_rate 5e-6 \
    --gradient_accumulation_steps 5 \
    --train_batch_size 1 \
    --clip_length 25 \
    --min_guidance_scale 3 --max_guidance_scale 7 \
    --noise_aug_strength 0.01 \
    --num_inference_steps 30 \
    --num_cond_bbox_frames 3 \
    --enable_gradient_checkpointing \
    --checkpointing_steps 500 \
    --output_dir output/bbox_predictor "$@"
