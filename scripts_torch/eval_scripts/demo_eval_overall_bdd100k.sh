#!/bin/bash
# The PyTorch port's counterpart of scripts/eval_scripts/demo_eval_overall_bdd100k.sh:
# the same flags and defaults through ctrlv_tpu_torch.tools.eval_overall.
# Run from the repository's root; it runs on the card (--device cpu for the CPU).
#
# Overall two-stage eval on BDD100K (50 steps, guidance 1->5, 400 samples).
python -m ctrlv_tpu_torch.tools.eval_overall \
    --dataset_name bdd100k \
    --data_root ./datasets \
    --clip_length 25 \
    --num_inference_steps 50 \
    --min_guidance_scale 1 --max_guidance_scale 5 \
    --num_demo_samples 400 \
    --output_dir output/eval_overall_bdd100k "$@"
