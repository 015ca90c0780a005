#!/bin/bash
# The port's twin of scripts/test_ytvos.sh:
# the same flags and environment defaults, run through _launch.sh (one
# GPU, or torchrun over NGPUS).
# Ref-YouTube-VOS inference to per-expression PNGs.
# Usage: test_ytvos.sh <checkpoint>.
# Its 36-frame chunks fit the memory-envelope row
# `eval resnet101 B=1 T=36` of
# ocpg_tpu_torch/scripts/memory_envelope.py:
# peak 2103.3 MiB allocated, hbm_frac 0.026, on an NVIDIA H100
# 80GB HBM3 at 700.00 W.
. "$(dirname "${BASH_SOURCE[0]}")/_launch.sh"
ocpg_launch ocpg_tpu_torch.cli.infer_ytvos \
  --ytvos_path ${YTVOS_PATH:-/data/refer-youtube-vos} \
  --checkpoint "$1" --output_dir output/ytvos_infer \
  --buckets exact
