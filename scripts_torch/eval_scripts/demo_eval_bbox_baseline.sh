#!/bin/bash
# The PyTorch port's counterpart of scripts/eval_scripts/demo_eval_bbox_baseline.sh:
# the same flags and defaults through ctrlv_tpu_torch.tools.eval_bbox_baseline.
# Run from the repository's root; it runs on the card (device=cpu for the CPU).
#
# Evaluate the AR bbox-predictor baseline (rollout + mask-IoU) — parity
# with the reference's demo_eval_trajeglish_baseline.sh (3 cond frames,
# batch 1, map embedding on).
DATASET="${DATASET:-kitti}"
python -m ctrlv_tpu_torch.tools.eval_bbox_baseline \
    dataset="$DATASET" \
    data_root=./datasets \
    seed=0 \
    initial_frames_condition_num=3 \
    val_batch_size=1 \
    map_embedding=true "$@"
