#!/usr/bin/env bash
# The port's twin of scripts/test_davis_videoswin_base.sh:
# the same flags and environment defaults, run through _launch.sh (one
# GPU, or torchrun over NGPUS).
# Ref-DAVIS inference with Video Swin-B over the GPUs, then offline J&F in
# one process (the reference's scripts/dist_test_davis_videoswinb.sh).
# Its 36-frame clips fit the memory-envelope row
# `eval video_swin_b_p4w7 B=1 T=36` of
# ocpg_tpu_torch/scripts/memory_envelope.py:
# peak 3301.8 MiB allocated, hbm_frac 0.04, on an NVIDIA H100
# 80GB HBM3 at 700.00 W.
set -ex
. "$(dirname "${BASH_SOURCE[0]}")/_launch.sh"
DATA_ROOT=${DATA_ROOT:-/data/ref-davis}
CKPT=${CKPT:-output/checkpoints}
ocpg_launch ocpg_tpu_torch.cli.infer_davis --davis_path "$DATA_ROOT" --checkpoint "$CKPT" \
  --backbone video_swin_b_p4w7 --output_dir output/davis_swinb --buckets exact
python -m ocpg_tpu_torch.cli.eval_davis --davis_path "$DATA_ROOT" \
  --results_path output/davis_swinb/valid
