"""Referring-expression detection metrics (RefCOCO pretraining eval): the
port's copy of ``ocpg_tpu/evaluation/refexp_metrics.py``.

The reference's refexp_eval.py: precision@k over the top-k scored boxes at
IoU 0.5.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _box_iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) -> (N, M)."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None] - inter
    return inter / np.maximum(union, 1e-9)


def evaluate_refexp(predictions: List[Dict], ground_truths: List[Dict],
                    ks: Sequence[int] = (1, 5, 10), iou_thresh: float = 0.5
                    ) -> Dict[str, float]:
    """predictions: [{image_id, boxes (Q,4) xyxy, scores (Q,)}];
    ground_truths: [{image_id, box (4,) xyxy}]."""
    gt_by_img = {g["image_id"]: np.asarray(g["box"], np.float32) for g in ground_truths}
    hits = {k: [] for k in ks}
    for p in predictions:
        gt = gt_by_img.get(p["image_id"])
        if gt is None:
            continue
        order = np.argsort(-np.asarray(p["scores"]))
        boxes = np.asarray(p["boxes"], np.float32)[order]
        ious = _box_iou_xyxy(boxes, gt[None])[:, 0]
        for k in ks:
            hits[k].append(float((ious[:k] > iou_thresh).any()))
    return {f"P@{k}": float(np.mean(hits[k])) if hits[k] else 0.0 for k in ks}
