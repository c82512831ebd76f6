#!/bin/bash
# The PyTorch port's counterpart of scripts/train_scripts/demo_train_svd_finetune.sh:
# the same flags and defaults through ctrlv_tpu_torch.tools.train_video_diffusion.
# Run from the repository's root; it runs on the card (--device cpu for the CPU).
#
# SVD full/temporal finetune on driving clips (lr 1e-5).
python -m ctrlv_tpu_torch.tools.train_video_diffusion \
    --dataset_name kitti \
    --data_root ./datasets \
    --learning_rate 1e-5 \
    --gradient_accumulation_steps 5 \
    --train_batch_size 1 \
    --clip_length 25 \
    --enable_gradient_checkpointing \
    --output_dir output/svd_finetune "$@"
