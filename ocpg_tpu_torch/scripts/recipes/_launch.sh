# Sourced by the recipes beside it.  `ocpg_launch <module> [args...]` runs
# `python -m <module> [args...]` on one GPU, or one process per GPU when
# NGPUS > 1:
#   OCPG_AUTO_DISTRIBUTED=1 torchrun --standalone --nproc_per_node $NGPUS -m <module> ...
# (ocpg_tpu_torch/parallel/distributed.py joins the ranks from torchrun's
# environment).  NGPUS defaults to the number of GPUs `nvidia-smi -L` lists,
# and to 1 without nvidia-smi.
#
# --batch_size is per rank, as in the JAX recipes (per device there): a run
# on N GPUs trains on a global batch of N x --batch_size, and the train and
# pretrain CLIs scale the learning rates by lr_scale(N) = max(N / 4, 1), as
# the JAX CLIs scale them by their device count.
if [ -z "${NGPUS:-}" ]; then
  NGPUS=$(nvidia-smi -L 2>/dev/null | grep -c '^GPU ' || true)
  [ "${NGPUS:-0}" -ge 1 ] || NGPUS=1
fi

ocpg_launch() {
  local module=$1
  shift
  if [ "$NGPUS" -gt 1 ]; then
    OCPG_AUTO_DISTRIBUTED=1 torchrun --standalone --nproc_per_node "$NGPUS" -m "$module" "$@"
  else
    python -m "$module" "$@"
  fi
}
