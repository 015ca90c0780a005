#!/bin/bash
# The port's twin of scripts/train_ytvos_videoswin_base.sh:
# the same flags and environment defaults, run through _launch.sh (one
# GPU, or torchrun over NGPUS).
# Ref-YouTube-VOS, Video Swin-B (the reference's per-GPU batch is 2).
# Per-GPU batch 2 (OCPG_BS overrides it) fits the memory-envelope row
# `train video_swin_b_p4w7 B=2 T=3 recompute off` of
# ocpg_tpu_torch/scripts/memory_envelope.py:
# peak 12849.9 MiB allocated, hbm_frac 0.157, on an NVIDIA H100
# 80GB HBM3 at 700.00 W.
# --batch_size is per GPU (per chip in the JAX recipe) and the learning
# rates scale by max(NGPUS / 4, 1), as the JAX CLI scales them by its chips.
. "$(dirname "${BASH_SOURCE[0]}")/_launch.sh"
ocpg_launch ocpg_tpu_torch.cli.train \
  --dataset_file ytvos --backbone video_swin_b_p4w7 --supervision box \
  --ytvos_path ${YTVOS_PATH:-/data/refer-youtube-vos} \
  --epochs 10 --num_frames 3 --batch_size ${OCPG_BS:-2} \
  --output_dir output/ytvos_vswin_b "$@"
