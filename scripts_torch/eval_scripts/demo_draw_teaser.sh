#!/bin/bash
# The PyTorch port's counterpart of scripts/eval_scripts/demo_draw_teaser.sh:
# the same flags and defaults through ctrlv_tpu_torch.tools.draw_teaser.
# Run from the repository's root; it runs on the card (--device cpu for the CPU).
#
# Teaser renderer: multi-seed two-stage generation with 3D-bbox overlays —
# parity with the reference's demo_draw_teaser.sh (50 steps, guidance 1->5,
# noise_aug 0.01, 100 samples, 3 cond frames).
DATASET="${DATASET:-kitti}"
python -m ctrlv_tpu_torch.tools.draw_teaser \
    --dataset_name "$DATASET" \
    --data_root ./datasets \
    --seed 123 \
    --clip_length 25 \
    --num_inference_steps 50 \
    --min_guidance_scale 1 --max_guidance_scale 5 \
    --noise_aug_strength 0.01 \
    --train_batch_size 1 \
    --num_demo_samples 100 \
    --num_cond_bbox_frames 3 \
    --output_dir "output/draw_teaser_$DATASET" "$@"
