#!/usr/bin/env bash
# The port's twin of scripts/test_a2d_resnet101.sh:
# the same flags and environment defaults, run through _launch.sh (one
# GPU, or torchrun over NGPUS).
# A2D-Sentences evaluation, ResNet-101 (the reference's
# scripts/dist_test_a2d_resnet101_boxsup.sh).
# Its clips fit the memory-envelope row
# `eval resnet101 B=1 T=5` of
# ocpg_tpu_torch/scripts/memory_envelope.py:
# peak 1242.4 MiB allocated, hbm_frac 0.015, on an NVIDIA H100
# 80GB HBM3 at 700.00 W.
set -ex
. "$(dirname "${BASH_SOURCE[0]}")/_launch.sh"
DATA_ROOT=${DATA_ROOT:-/data/a2d}
CKPT=${CKPT:-output/checkpoints}
ocpg_launch ocpg_tpu_torch.cli.evaluate \
  --dataset_file a2d --backbone resnet101 --a2d_path "$DATA_ROOT" --checkpoint "$CKPT"
