#!/bin/bash
# The port's twin of scripts/train_a2d_resnet101_pointsup.sh:
# the same flags and environment defaults, run through _launch.sh (one
# GPU, or torchrun over NGPUS).
# A2D-Sentences, ResNet-101, point supervision.
# Per-GPU batch 2 (OCPG_BS overrides it) fits the memory-envelope row
# `train resnet101 B=2 T=3 recompute off` of
# ocpg_tpu_torch/scripts/memory_envelope.py:
# peak 8895.2 MiB allocated, hbm_frac 0.109, on an NVIDIA H100
# 80GB HBM3 at 700.00 W.
# --batch_size is per GPU (per chip in the JAX recipe) and the learning
# rates scale by max(NGPUS / 4, 1), as the JAX CLI scales them by its chips.
. "$(dirname "${BASH_SOURCE[0]}")/_launch.sh"
ocpg_launch ocpg_tpu_torch.cli.train \
  --dataset_file a2d --backbone resnet101 --supervision point \
  --a2d_path ${A2D_PATH:-/data/a2d-sentences} \
  --epochs 12 --num_frames 3 --batch_size ${OCPG_BS:-2} \
  --output_dir output/a2d_r101_pointsup "$@"
