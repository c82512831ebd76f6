#!/bin/bash
# The PyTorch port's counterpart of scripts/eval_scripts/demo_eval_video_svd.sh:
# the same flags and defaults through ctrlv_tpu_torch.tools.eval_video_generation.
# Run from the repository's root; it runs on the card (--device cpu for the CPU).
#
# Plain SVD video generation eval (FVD baseline, no bbox conditioning) —
# parity with the reference's demo_eval_video_svd.sh (50 steps, guidance
# 1->3, noise_aug 0.01, 200 samples).
DATASET="${DATASET:-kitti}"
python -m ctrlv_tpu_torch.tools.eval_video_generation \
    --dataset_name "$DATASET" \
    --data_root ./datasets \
    --run_name "$DATASET-baseline-final-eval" \
    --seed 123 \
    --clip_length 25 \
    --num_inference_steps 50 \
    --min_guidance_scale 1 --max_guidance_scale 3 \
    --noise_aug_strength 0.01 \
    --train_batch_size 1 \
    --bbox_dropout_prob 0.1 \
    --num_demo_samples 200 \
    --output_dir "output/eval_video_svd_$DATASET" "$@"
