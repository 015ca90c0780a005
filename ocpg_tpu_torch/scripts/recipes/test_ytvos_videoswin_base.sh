#!/usr/bin/env bash
# The port's twin of scripts/test_ytvos_videoswin_base.sh:
# the same flags and environment defaults, run through _launch.sh (one
# GPU, or torchrun over NGPUS).
# Ref-YouTube-VOS inference with Video Swin-B to per-expression mask PNGs
# for server-side scoring (the reference's
# scripts/dist_test_ytvos_videoswinb.sh).
# Its 36-frame chunks fit the memory-envelope row
# `eval video_swin_b_p4w7 B=1 T=36` of
# ocpg_tpu_torch/scripts/memory_envelope.py:
# peak 3301.8 MiB allocated, hbm_frac 0.04, on an NVIDIA H100
# 80GB HBM3 at 700.00 W.
set -ex
. "$(dirname "${BASH_SOURCE[0]}")/_launch.sh"
DATA_ROOT=${DATA_ROOT:-/data/ref-youtube-vos}
CKPT=${CKPT:-output/checkpoints}
ocpg_launch ocpg_tpu_torch.cli.infer_ytvos --ytvos_path "$DATA_ROOT" --checkpoint "$CKPT" \
  --backbone video_swin_b_p4w7 --output_dir output/ytvos_swinb --buckets exact
