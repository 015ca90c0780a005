"""Evaluation metrics: the port's copies of ``ocpg_tpu/evaluation``."""
from .davis_metrics import db_eval_iou, db_eval_boundary  # noqa: F401
from .rle import rle_encode, rle_decode  # noqa: F401
