#!/bin/bash
# The PyTorch port's counterpart of scripts/train_scripts/demo_train_bbox_baseline.sh:
# the same flags and defaults through ctrlv_tpu_torch.tools.train_bbox_baseline.
# Run from the repository's root; it runs on the card (device=cpu for the CPU).
#
# Train the trajeglish-style AR bbox-predictor baseline — parity with the
# reference's demo_train_bbox_trajeglish_baseline.sh (hydra-style key=value
# overrides: 3 cond frames, state embeddings, batch 16, 15 agents — use
# max_num_agents=30 for BDD100K — 20k steps).
DATASET="${DATASET:-kitti}"
python -m ctrlv_tpu_torch.tools.train_bbox_baseline \
    dataset="$DATASET" \
    data_root=./datasets \
    seed=0 \
    initial_frames_condition_num=3 \
    use_state_embeddings=true \
    train_batch_size=16 \
    val_batch_size=16 \
    map_embedding=true \
    max_num_agents=15 \
    pred_coords=false \
    always_predict_initial_agents=false \
    max_steps=20000 "$@"
