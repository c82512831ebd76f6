#!/bin/bash
# The PyTorch port's counterpart of scripts/train_scripts/demo_train_vae.sh:
# the same flags and defaults through ctrlv_tpu_torch.tools.train_vae_finetuning.
# Run from the repository's root; it runs on the card (--device cpu for the CPU).
#
# VAE decoder finetune (image MSE).
python -m ctrlv_tpu_torch.tools.train_vae_finetuning \
    --dataset_name kitti \
    --data_root ./datasets \
    --learning_rate 1e-5 \
    --train_batch_size 1 \
    --clip_length 25 \
    --output_dir output/vae_finetune "$@"
