"""A2D/JHMDB evaluation: P@K, overall/mean IoU, and COCO-style segm mAP.
The port's copy of ``ocpg_tpu/evaluation/a2d_metrics.py``.

The reference's a2d_eval.py (precision@{0.5..0.9}, overall/mean IoU) and
its COCOeval(segm, useCats=0) call, without pycocotools: greedy per-image
assignment by score order, 101-point interpolated AP averaged over IoU
0.5:0.05:0.95.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .rle import rle_decode

IOU_THRESHOLDS = np.round(np.arange(0.5, 1.0, 0.05), 2)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)


def _mask_iou(pred_mask: np.ndarray, gt_mask: np.ndarray) -> float:
    union = (pred_mask | gt_mask).sum()
    if union == 0:
        return 0.0
    return float((pred_mask & gt_mask).sum() / union)


def evaluate_a2d(predictions: List[Dict], ground_truths: List[Dict]) -> Dict[str, float]:
    """predictions: [{image_id, score, rle}], ground_truths: [{image_id, rle}].

    Multiple predictions per image are allowed (the reference emits one per
    query, engine.py:150-165); each GT is matched greedily by score.
    """
    gt_by_img: Dict = {}
    for g in ground_truths:
        gt_by_img.setdefault(g["image_id"], []).append(g)

    preds = sorted(predictions, key=lambda p: -p["score"])

    # per-image best-prediction IoU for P@K / IoU metrics (a2d_eval.py:63-96):
    # the reference computes these from the top-scoring prediction per image
    best_by_img: Dict = {}
    for p in preds:
        if p["image_id"] not in best_by_img:
            best_by_img[p["image_id"]] = p

    ious = []
    inters, unions = 0.0, 0.0
    eps = 1e-6  # reference compute_mask_iou EPS (a2d_eval.py:26-33)
    for img_id, gts in gt_by_img.items():
        gt_mask = rle_decode(gts[0]["rle"]).astype(bool)
        p = best_by_img.get(img_id)
        pm = rle_decode(p["rle"]).astype(bool) if p is not None else np.zeros_like(gt_mask)
        inter = float((pm & gt_mask).sum())
        union = float((pm | gt_mask).sum())
        ious.append((inter + eps) / (union + eps))
        inters += inter
        unions += union
    ious = np.asarray(ious)

    out = {
        "overall_iou": float(inters / max(unions, 1.0)),
        "mean_iou": float(ious.mean()) if len(ious) else 0.0,
    }
    for k in (0.5, 0.6, 0.7, 0.8, 0.9):
        out[f"P@{k}"] = float((ious > k).mean()) if len(ious) else 0.0

    # COCO-style AP over IoU thresholds (one category, useCats=0,
    # maxDets=100, area=all) matching COCOeval.accumulate semantics
    max_dets = 100
    per_img_count: Dict = {}
    kept = []
    for p in preds:                       # preds already score-sorted
        c = per_img_count.get(p["image_id"], 0)
        if c < max_dets:
            kept.append(p)
            per_img_count[p["image_id"]] = c + 1
    preds = kept
    # each prediction's IoU with each ground truth of its image, decoded once
    gt_bits = {img: [rle_decode(g["rle"]).astype(bool) for g in gts]
               for img, gts in gt_by_img.items()}
    pair_ious = []
    for p in preds:
        pm = rle_decode(p["rle"]).astype(bool)
        pair_ious.append([_mask_iou(pm, gm) for gm in gt_bits.get(p["image_id"], [])])
    aps = []
    ap50 = ap75 = 0.0
    n_gt = len(ground_truths)
    for thr in IOU_THRESHOLDS:
        matched = set()
        tp = np.zeros(len(preds))
        fp = np.zeros(len(preds))
        for i, p in enumerate(preds):
            best_iou, best_j = 0.0, -1
            for j, iou in enumerate(pair_ious[i]):
                key = (p["image_id"], j)
                if key in matched:
                    continue
                if iou > best_iou:
                    best_iou, best_j = iou, j
            if best_iou >= thr and best_j >= 0:
                tp[i] = 1
                matched.add((p["image_id"], best_j))
            else:
                fp[i] = 1
        ctp, cfp = np.cumsum(tp), np.cumsum(fp)
        recall = ctp / max(n_gt, 1)
        precision = ctp / np.maximum(ctp + cfp, 1e-9)
        # precision envelope, then COCOeval's step-function lookup: for each
        # recall point take precision at the FIRST index with recall >= r
        # (searchsorted left), zero past the last achieved recall — COCOeval
        # does not linearly interpolate
        for i in range(len(precision) - 1, 0, -1):
            precision[i - 1] = max(precision[i - 1], precision[i])
        if len(preds):
            inds = np.searchsorted(recall, RECALL_POINTS, side="left")
            q = np.zeros(len(RECALL_POINTS))
            valid = inds < len(precision)
            q[valid] = precision[inds[valid]]
            ap = float(q.mean())
        else:
            ap = 0.0
        aps.append(ap)
        if abs(thr - 0.5) < 1e-6:
            ap50 = ap
        if abs(thr - 0.75) < 1e-6:
            ap75 = ap
    out["mAP 0.5:0.95"] = float(np.mean(aps)) if aps else 0.0
    out["AP50"] = ap50
    out["AP75"] = ap75
    return out
