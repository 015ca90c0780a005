#!/bin/bash
# The port's twin of scripts/train_ytvos_resnet101_boxsup.sh:
# the same flags and environment defaults, run through _launch.sh (one
# GPU, or torchrun over NGPUS).
# Ref-YouTube-VOS, ResNet-101, box supervision (the reference's
# scripts/dist_train_ytvos_resnet101_boxsup.sh passes no --batch_size, so
# its opts.py default 1 is the per-GPU batch).
# Per-GPU batch 1 (OCPG_BS overrides it) fits the memory-envelope row
# `train resnet101 B=1 T=3 recompute off` of
# ocpg_tpu_torch/scripts/memory_envelope.py:
# peak 5212.0 MiB allocated, hbm_frac 0.064, on an NVIDIA H100
# 80GB HBM3 at 700.00 W.
# --batch_size is per GPU (per chip in the JAX recipe) and the learning
# rates scale by max(NGPUS / 4, 1), as the JAX CLI scales them by its chips.
. "$(dirname "${BASH_SOURCE[0]}")/_launch.sh"
ocpg_launch ocpg_tpu_torch.cli.train \
  --dataset_file ytvos --backbone resnet101 --supervision box \
  --ytvos_path ${YTVOS_PATH:-/data/refer-youtube-vos} \
  --epochs 10 --num_frames 3 --batch_size ${OCPG_BS:-1} \
  --output_dir output/ytvos_r101_boxsup "$@"
