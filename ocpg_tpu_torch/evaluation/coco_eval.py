"""COCOeval-faithful detection metrics: the full 12-stat summary with
IoU-threshold sweep, area ranges, and maxDets.  The port's copy of
``ocpg_tpu/evaluation/coco_eval.py``.

The reference's pretrain eval prints pycocotools COCOeval's bbox and segm
stats; this is COCOeval.evaluateImg/accumulate/summarize without
pycocotools (greedy per-image score-ordered matching with gt-ignore
handling, 101-point interpolated AP, per-(area, maxDet) breakdown), in
numpy.  Matching is category-free (useCats=0), which is how the reference
runs every referring-grounding evaluation (one referred object per image).

Inputs are plain dicts:
  predictions:  {image_id, score, box (xyxy) | rle}
  ground_truths:{image_id, box (xyxy) | rle, area?, iscrowd?}
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .rle import rle_decode

IOU_THRESHOLDS = np.round(np.arange(0.5, 1.0, 0.05), 2)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)
AREA_RANGES: Tuple[Tuple[str, float, float], ...] = (
    ("all", 0.0, 1e10),
    ("small", 0.0, 32.0 ** 2),
    ("medium", 32.0 ** 2, 96.0 ** 2),
    ("large", 96.0 ** 2, 1e10),
)
MAX_DETS = (1, 10, 100)


def _box_iou(dt: np.ndarray, gt: np.ndarray, crowd: np.ndarray) -> np.ndarray:
    """IoU matrix (n_dt, n_gt) for xyxy boxes; crowd gt -> intersection/dt_area."""
    n_d, n_g = len(dt), len(gt)
    out = np.zeros((n_d, n_g))
    for j in range(n_g):
        gx0, gy0, gx1, gy1 = gt[j]
        ga = max(gx1 - gx0, 0.0) * max(gy1 - gy0, 0.0)
        for i in range(n_d):
            dx0, dy0, dx1, dy1 = dt[i]
            da = max(dx1 - dx0, 0.0) * max(dy1 - dy0, 0.0)
            iw = min(dx1, gx1) - max(dx0, gx0)
            ih = min(dy1, gy1) - max(dy0, gy0)
            inter = max(iw, 0.0) * max(ih, 0.0)
            denom = da if crowd[j] else da + ga - inter
            out[i, j] = inter / denom if denom > 0 else 0.0
    return out


def _mask_iou(dts: Sequence[np.ndarray], gts: Sequence[np.ndarray],
              crowd: np.ndarray) -> np.ndarray:
    out = np.zeros((len(dts), len(gts)))
    for j, g in enumerate(gts):
        for i, d in enumerate(dts):
            inter = float(np.logical_and(d, g).sum())
            denom = float(d.sum()) if crowd[j] else float(np.logical_or(d, g).sum())
            out[i, j] = inter / denom if denom > 0 else 0.0
    return out


class CocoEvaluatorLite:
    """COCOeval(useCats=0) equivalent for one iou_type ('bbox' | 'segm')."""

    def __init__(self, iou_type: str = "bbox"):
        assert iou_type in ("bbox", "segm")
        self.iou_type = iou_type

    def _dt_area(self, p: Dict) -> float:
        if self.iou_type == "bbox":
            x0, y0, x1, y1 = p["box"]
            return max(x1 - x0, 0.0) * max(y1 - y0, 0.0)
        return float(rle_decode(p["rle"]).sum())

    def _gt_area(self, g: Dict) -> float:
        if "area" in g:
            return float(g["area"])
        return self._dt_area(g)

    def evaluate(self, predictions: List[Dict], ground_truths: List[Dict]) -> Dict[str, float]:
        img_ids = sorted({g["image_id"] for g in ground_truths}
                         | {p["image_id"] for p in predictions})
        dts_by_img: Dict = {i: [] for i in img_ids}
        gts_by_img: Dict = {i: [] for i in img_ids}
        for p in predictions:
            dts_by_img[p["image_id"]].append(p)
        for g in ground_truths:
            gts_by_img[g["image_id"]].append(g)

        T, A, M = len(IOU_THRESHOLDS), len(AREA_RANGES), len(MAX_DETS)
        # per (img, area, maxdet): dt scores + tp/ignore flags per threshold
        evals: Dict = {}
        for img in img_ids:
            dts = sorted(dts_by_img[img], key=lambda p: -p["score"])[: max(MAX_DETS)]
            gts = gts_by_img[img]
            crowd = np.asarray([bool(g.get("iscrowd", 0)) for g in gts])
            if self.iou_type == "bbox":
                ious_full = _box_iou(
                    np.asarray([d["box"] for d in dts], np.float64).reshape(-1, 4),
                    np.asarray([g["box"] for g in gts], np.float64).reshape(-1, 4),
                    crowd)
            else:
                ious_full = _mask_iou(
                    [rle_decode(d["rle"]).astype(bool) for d in dts],
                    [rle_decode(g["rle"]).astype(bool) for g in gts], crowd)
            dt_areas = np.asarray([self._dt_area(d) for d in dts])
            gt_areas = np.asarray([self._gt_area(g) for g in gts])

            for ai, (_, a0, a1) in enumerate(AREA_RANGES):
                gt_ig = np.asarray(
                    [bool(g.get("iscrowd", 0)) or not (a0 <= ar <= a1)
                     for g, ar in zip(gts, gt_areas)])
                # COCOeval sorts gts ignored-last (evaluateImg)
                gorder = np.argsort(gt_ig, kind="stable")
                ious = ious_full[:, gorder] if len(gts) else ious_full
                gig = gt_ig[gorder] if len(gts) else gt_ig
                gcrowd = crowd[gorder] if len(gts) else crowd
                for mi, max_det in enumerate(MAX_DETS):
                    nd = min(len(dts), max_det)
                    dtm = -np.ones((T, nd), np.int64)
                    gtm = -np.ones((T, len(gts)), np.int64)
                    for ti, thr in enumerate(IOU_THRESHOLDS):
                        for di in range(nd):
                            iou = min(thr, 1 - 1e-10)
                            m = -1
                            for gi in range(len(gts)):
                                if gtm[ti, gi] >= 0 and not gcrowd[gi]:
                                    continue
                                # non-ignored gts exhausted: stop at first ignored
                                # if already matched to a non-ignored gt
                                if m > -1 and not gig[m] and gig[gi]:
                                    break
                                if ious[di, gi] < iou:
                                    continue
                                iou = ious[di, gi]
                                m = gi
                            if m != -1:
                                dtm[ti, di] = m
                                gtm[ti, m] = di
                    dt_out_of_range = ~((a0 <= dt_areas[:nd]) & (dt_areas[:nd] <= a1))
                    dt_ig = np.where(
                        dtm >= 0,
                        gig[np.maximum(dtm, 0)],
                        dt_out_of_range[None, :],
                    )
                    evals[(img, ai, mi)] = {
                        "scores": np.asarray([d["score"] for d in dts[:nd]]),
                        "tp": dtm >= 0,
                        "dt_ig": dt_ig,
                        "n_gt": int((~gig).sum()),
                    }

        # accumulate (COCOeval.accumulate)
        precision = -np.ones((T, len(RECALL_POINTS), A, M))
        recall = -np.ones((T, A, M))
        for ai in range(A):
            for mi in range(M):
                es = [evals[(img, ai, mi)] for img in img_ids]
                scores = np.concatenate([e["scores"] for e in es]) if es else np.zeros(0)
                order = np.argsort(-scores, kind="mergesort")
                tp = np.concatenate([e["tp"] for e in es], axis=1)[:, order] \
                    if es else np.zeros((T, 0), bool)
                ig = np.concatenate([e["dt_ig"] for e in es], axis=1)[:, order] \
                    if es else np.zeros((T, 0), bool)
                npig = sum(e["n_gt"] for e in es)
                if npig == 0:
                    continue
                tps = np.logical_and(tp, ~ig)
                fps = np.logical_and(~tp, ~ig)
                for ti in range(T):
                    ctp = np.cumsum(tps[ti]).astype(np.float64)
                    cfp = np.cumsum(fps[ti]).astype(np.float64)
                    rc = ctp / npig
                    pr = ctp / np.maximum(ctp + cfp, np.spacing(1))
                    recall[ti, ai, mi] = rc[-1] if len(rc) else 0.0
                    for i in range(len(pr) - 1, 0, -1):
                        pr[i - 1] = max(pr[i - 1], pr[i])
                    inds = np.searchsorted(rc, RECALL_POINTS, side="left")
                    q = np.zeros(len(RECALL_POINTS))
                    valid = inds < len(pr)
                    q[valid] = pr[inds[valid]]
                    precision[ti, :, ai, mi] = q

        def _summ(ap: bool, area: str = "all", max_det: int = 100,
                  thr: Optional[float] = None) -> float:
            ai = [i for i, (n, *_u) in enumerate(AREA_RANGES) if n == area][0]
            mi = MAX_DETS.index(max_det)
            if ap:
                s = precision[:, :, ai, mi]
                if thr is not None:
                    s = s[[int(np.argwhere(np.isclose(IOU_THRESHOLDS, thr))[0][0])]]
            else:
                s = recall[:, ai, mi]
                if thr is not None:
                    s = s[[int(np.argwhere(np.isclose(IOU_THRESHOLDS, thr))[0][0])]]
            s = s[s > -1]
            return float(s.mean()) if s.size else -1.0

        return {
            "AP": _summ(True),
            "AP50": _summ(True, thr=0.5),
            "AP75": _summ(True, thr=0.75),
            "AP_small": _summ(True, area="small"),
            "AP_medium": _summ(True, area="medium"),
            "AP_large": _summ(True, area="large"),
            "AR@1": _summ(False, max_det=1),
            "AR@10": _summ(False, max_det=10),
            "AR@100": _summ(False, max_det=100),
            "AR_small": _summ(False, area="small"),
            "AR_medium": _summ(False, area="medium"),
            "AR_large": _summ(False, area="large"),
        }
