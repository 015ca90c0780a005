#!/bin/bash
# The port's twin of scripts/test_davis.sh:
# the same flags and environment defaults, run through _launch.sh (one
# GPU, or torchrun over NGPUS).
# Ref-DAVIS inference, then J&F per annotator (the reference's
# scripts/dist_test_davis_*.sh and eval_davis.py); the scoring is one
# process.  Usage: test_davis.sh <checkpoint>.
# Its 36-frame clips fit the memory-envelope row
# `eval resnet101 B=1 T=36` of
# ocpg_tpu_torch/scripts/memory_envelope.py:
# peak 2103.3 MiB allocated, hbm_frac 0.026, on an NVIDIA H100
# 80GB HBM3 at 700.00 W.
. "$(dirname "${BASH_SOURCE[0]}")/_launch.sh"
ocpg_launch ocpg_tpu_torch.cli.infer_davis \
  --davis_path ${DAVIS_PATH:-/data/ref-davis} \
  --checkpoint "$1" --output_dir output/davis_infer \
  --buckets exact
for anno in 0 1 2 3; do
  python -m ocpg_tpu_torch.cli.eval_davis \
    --davis_path ${DAVIS_PATH:-/data/ref-davis}/valid \
    --results_path output/davis_infer/valid/anno_${anno}
done
