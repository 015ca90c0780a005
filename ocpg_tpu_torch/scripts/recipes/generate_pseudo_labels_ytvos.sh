#!/bin/bash
# The port's twin of scripts/generate_pseudo_labels_ytvos.sh:
# the same flags and environment defaults, run through _launch.sh (one
# GPU, or torchrun over NGPUS).
# Offline pseudo-label generation for Ref-YouTube-VOS (the reference's
# pre_process/generate_anno.py).  Reads and writes h5 files (ocpg_tpu_torch/data/h5.py, no h5py).
# One process: the generator has no multi-GPU path.
. "$(dirname "${BASH_SOURCE[0]}")/_launch.sh"
python -m ocpg_tpu_torch.preprocess.generate_anno --dataset ytvos \
  --root ${YTVOS_PATH:-/data/refer-youtube-vos} \
  --densecl ${DENSECL_CKPT:-checkpoints/densecl_r101_imagenet_200ep.pth} "$@"
