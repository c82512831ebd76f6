#!/bin/bash
# The PyTorch port's counterpart of scripts/eval_scripts/demo_eval_box2video_teacher_forced.sh:
# the same flags and defaults through ctrlv_tpu_torch.tools.eval_video_controlnet.
# Run from the repository's root; it runs on the card (--device cpu for the CPU).
#
# Teacher-forced Box2Video eval (GT boxes as conditioning).
python -m ctrlv_tpu_torch.tools.eval_video_controlnet \
    --dataset_name bdd100k \
    --data_root ./datasets \
    --clip_length 25 \
    --num_inference_steps 25 \
    --min_guidance_scale 1 --max_guidance_scale 3 \
    --num_demo_samples 200 \
    --output_dir output/eval_box2video_tf "$@"
