#!/usr/bin/env bash
# The port's twin of scripts/pretrain_refcoco.sh:
# the same flags and environment defaults, run through _launch.sh (one
# GPU, or torchrun over NGPUS).
# RefCOCO/+/g pretraining with a val per epoch (the reference's
# main_pretrain.py).
# The CLI's default per-GPU batch 2 (at --num_frames 3) fits the memory-envelope row
# `train resnet101 B=2 T=3 recompute off` of
# ocpg_tpu_torch/scripts/memory_envelope.py:
# peak 8895.2 MiB allocated, hbm_frac 0.109, on an NVIDIA H100
# 80GB HBM3 at 700.00 W.
# --batch_size is per GPU (per chip in the JAX recipe) and the learning
# rates scale by max(NGPUS / 4, 1), as the JAX CLI scales them by its chips.
set -ex
. "$(dirname "${BASH_SOURCE[0]}")/_launch.sh"
COCO=${COCO:-/data/coco}
ocpg_launch ocpg_tpu_torch.cli.pretrain --dataset_file all --coco_path "$COCO" \
  --as_sequence --num_frames 3 --output_dir output/pretrain_all
