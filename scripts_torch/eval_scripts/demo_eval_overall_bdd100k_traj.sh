#!/bin/bash
# The PyTorch port's counterpart of scripts/eval_scripts/demo_eval_overall_bdd100k_traj.sh:
# the same flags and defaults through ctrlv_tpu_torch.tools.eval_overall.
# Run from the repository's root; it runs on the card (--device cpu for the CPU).
#
# Overall two-stage eval on BDD100K with last-frame TRAJECTORY conditioning
# (the box-center-dot variant; reference demo_eval_overall_bdd100k_traj.sh:
# 50 steps, guidance 1->5, noise_aug 0.01, 300 samples,
# --if_last_frame_trajectory).
python -m ctrlv_tpu_torch.tools.eval_overall \
    --dataset_name bdd100k \
    --data_root ./datasets \
    --seed 123 \
    --clip_length 25 \
    --num_inference_steps 50 \
    --min_guidance_scale 1 --max_guidance_scale 5 \
    --noise_aug_strength 0.01 \
    --train_batch_size 1 \
    --num_demo_samples 300 \
    --if_last_frame_trajectory \
    --output_dir output/eval_overall_bdd100k_traj "$@"
