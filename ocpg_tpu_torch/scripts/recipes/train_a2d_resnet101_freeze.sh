#!/usr/bin/env bash
# The port's twin of scripts/train_a2d_resnet101_freeze.sh:
# the same flags and environment defaults, run through _launch.sh (one
# GPU, or torchrun over NGPUS).
# A2D-Sentences, ResNet-101, frozen video encoder (the reference's
# scripts/dist_train_a2d_resnet101_freeze.sh).
# Per-GPU batch 4 (OCPG_BS overrides it) fits the memory-envelope row
# `train resnet101 B=4 T=3 recompute off` of
# ocpg_tpu_torch/scripts/memory_envelope.py (measured
# with the video encoder trained: freezing it needs less):
# peak 16274.2 MiB allocated, hbm_frac 0.199, on an NVIDIA H100
# 80GB HBM3 at 700.00 W.
# --batch_size is per GPU (per chip in the JAX recipe) and the learning
# rates scale by max(NGPUS / 4, 1), as the JAX CLI scales them by its chips.
set -ex
. "$(dirname "${BASH_SOURCE[0]}")/_launch.sh"
DATA_ROOT=${DATA_ROOT:-/data/a2d}
ocpg_launch ocpg_tpu_torch.cli.train \
  --dataset_file a2d --backbone resnet101 --supervision box \
  --a2d_path "$DATA_ROOT" --batch_size ${OCPG_BS:-4} \
  --output_dir output/train_a2d_resnet101_freeze --epochs 12 --lr_drop 3 5 --freeze_video_encoder
