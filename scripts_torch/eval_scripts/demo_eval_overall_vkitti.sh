#!/bin/bash
# The PyTorch port's counterpart of scripts/eval_scripts/demo_eval_overall_vkitti.sh:
# the same flags and defaults through ctrlv_tpu_torch.tools.eval_overall.
# Run from the repository's root; it runs on the card (--device cpu for the CPU).
#
# Overall two-stage eval on Virtual KITTI 2 — canonical protocol
# (50 steps, guidance 1->5, noise_aug 0.01, 200 samples; parity with the
# reference's demo_eval_overall_vkitti.sh).
python -m ctrlv_tpu_torch.tools.eval_overall \
    --dataset_name vkitti \
    --data_root ./datasets \
    --seed 123 \
    --clip_length 25 \
    --num_inference_steps 50 \
    --min_guidance_scale 1 --max_guidance_scale 5 \
    --noise_aug_strength 0.01 \
    --train_batch_size 1 \
    --num_demo_samples 200 \
    --num_cond_bbox_frames 3 \
    --output_dir output/eval_overall_vkitti "$@"
