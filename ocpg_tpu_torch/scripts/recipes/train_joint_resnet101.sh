#!/bin/bash
# The port's twin of scripts/train_joint_resnet101.sh:
# the same flags and environment defaults, run through _launch.sh (one
# GPU, or torchrun over NGPUS).
# Joint training: RefCOCO/+/g pseudo-video clips and Ref-YouTube-VOS (the
# reference's datasets/concat_dataset.py:19-34, registry entry 'joint').
# Per-GPU batch 2 (OCPG_BS overrides it) fits the memory-envelope row
# `train resnet101 B=2 T=3 recompute off` of
# ocpg_tpu_torch/scripts/memory_envelope.py:
# peak 8895.2 MiB allocated, hbm_frac 0.109, on an NVIDIA H100
# 80GB HBM3 at 700.00 W.
# --batch_size is per GPU (per chip in the JAX recipe) and the learning
# rates scale by max(NGPUS / 4, 1), as the JAX CLI scales them by its chips.
. "$(dirname "${BASH_SOURCE[0]}")/_launch.sh"
ocpg_launch ocpg_tpu_torch.cli.train \
  --dataset_file joint --backbone resnet101 --supervision full \
  --ytvos_path ${YTVOS_PATH:-/data/refer-youtube-vos} \
  --coco_path ${COCO_PATH:-/data/coco} \
  --refexp_ann_dir ${REFEXP_ANN_DIR:-/data/coco/refexp_anns} \
  --epochs 10 --num_frames 3 --batch_size ${OCPG_BS:-2} \
  --output_dir output/joint_r101 "$@"
