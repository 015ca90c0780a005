#!/usr/bin/env bash
# The port's twin of scripts/train_a2d_resnet101_boxvos.sh:
# the same flags and environment defaults, run through _launch.sh (one
# GPU, or torchrun over NGPUS).
# A2D-Sentences, ResNet-101, box supervision with the pairwise losses (the
# reference's scripts/dist_train_a2d_resnet101_boxvos.sh).
# NOTE: the reference passes --supervision_type to main.py but its opts.py
# has no such flag, so its recipe dies in argparse.  Here the flag parses
# and boxvos enables the BoxInst pairwise color-similarity losses
# (ocpg_tpu_torch/models/pairwise.py; PARITY.md "BoxInst pairwise").
# Per-GPU batch 2 (OCPG_BS overrides it) fits the memory-envelope row
# `train resnet101 B=2 T=3 recompute off` of
# ocpg_tpu_torch/scripts/memory_envelope.py:
# peak 8895.2 MiB allocated, hbm_frac 0.109, on an NVIDIA H100
# 80GB HBM3 at 700.00 W.
# --batch_size is per GPU (per chip in the JAX recipe) and the learning
# rates scale by max(NGPUS / 4, 1), as the JAX CLI scales them by its chips.
set -ex
. "$(dirname "${BASH_SOURCE[0]}")/_launch.sh"
DATA_ROOT=${DATA_ROOT:-/data/a2d}
ocpg_launch ocpg_tpu_torch.cli.train \
  --dataset_file a2d --backbone resnet101 --supervision box --supervision_type boxvos \
  --a2d_path "$DATA_ROOT" --batch_size ${OCPG_BS:-2} \
  --output_dir output/train_a2d_resnet101_boxvos --epochs 12 --lr_drop 3 5
