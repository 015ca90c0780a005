"""The offline pseudo-label generator (the sim model, the dense CRF,
``generate_anno``): counterpart of ``ocpg_tpu/preprocess``."""
