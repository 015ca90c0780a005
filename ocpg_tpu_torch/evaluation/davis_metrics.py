"""DAVIS J (region IoU) and F (boundary) measures, the official algorithm in
numpy: the port's copy of ``ocpg_tpu/evaluation/davis_metrics.py``.

J is IoU with void-pixel exclusion; F is the boundary f-measure of the
1-pixel ``_seg2bmap`` boundary maps (the David Martin half-pixel-offset
convention) matched within a ``skimage.morphology.disk(bound_pix)``
dilation.  ``_disk`` is the Euclidean-disk formula.  Void pixels (palette
index 255) are excluded from J's intersection and union and zeroed out of
both masks before boundary extraction, as in the reference.

The JAX module dilates with ``cv2.dilate``, whose default border adds
nothing from outside the map.  ``_dilate_disk`` is the same binary
dilation in numpy, so the results are cv2's without cv2.
"""

from __future__ import annotations

import numpy as np


def db_eval_iou(annotation: np.ndarray, segmentation: np.ndarray,
                void_pixels: np.ndarray | None = None) -> np.ndarray:
    """Region similarity J per frame; inputs (T, H, W) or (H, W) binary.

    Void pixels are excluded from both intersection and union
    (davis2017/metrics.py:21-31).
    """
    assert annotation.shape == segmentation.shape, \
        f"shape mismatch: {annotation.shape} vs {segmentation.shape}"
    ann = annotation > 0.5
    seg = segmentation > 0.5
    if void_pixels is not None:
        assert void_pixels.shape == annotation.shape, \
            f"void shape mismatch: {void_pixels.shape} vs {annotation.shape}"
        valid = ~(void_pixels > 0.5)
    else:
        valid = np.ones_like(seg)
    axis = tuple(range(ann.ndim - 2, ann.ndim))
    inter = ((ann & seg) & valid).sum(axis=axis).astype(np.float64)
    union = ((ann | seg) & valid).sum(axis=axis).astype(np.float64)
    j = np.where(union == 0, 1.0, inter / np.maximum(union, 1))
    return j


def _seg2bmap(seg: np.ndarray) -> np.ndarray:
    """1-pixel-wide binary boundary map, pixels offset 1/2 px toward the
    origin from the true segment boundary (davis2017/metrics.py:122-178,
    the published David Martin / BSDS convention).

    A pixel is boundary iff it differs from its east, south, or south-east
    neighbour — except on the last row (east test only), last column (south
    test only), and the bottom-right corner (never boundary).
    """
    seg = seg > 0.5
    e = np.zeros_like(seg)
    s = np.zeros_like(seg)
    se = np.zeros_like(seg)
    e[:, :-1] = seg[:, 1:]
    s[:-1, :] = seg[1:, :]
    se[:-1, :-1] = seg[1:, 1:]

    b = (seg ^ e) | (seg ^ s) | (seg ^ se)
    b[-1, :] = seg[-1, :] ^ e[-1, :]
    b[:, -1] = seg[:, -1] ^ s[:, -1]
    b[-1, -1] = False
    return b


def _disk(radius: float) -> np.ndarray:
    """Euclidean-disk structuring element: ``skimage.morphology.disk``
    (strict radius)."""
    L = np.arange(-radius, radius + 1)
    X, Y = np.meshgrid(L, L)
    return ((X ** 2 + Y ** 2) <= radius ** 2).astype(np.uint8)


def _dilate_disk(b: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Binary dilation of the (H, W) map ``b`` by a ``_disk`` kernel anchored
    at its centre (``k // 2``), with nothing dilating in from outside the
    map (``cv2.dilate``'s default border).  Only the box of set pixels,
    widened by the kernel, can change: the dilation runs there."""
    out = np.zeros(b.shape, bool)
    rows, cols = np.flatnonzero(b.any(1)), np.flatnonzero(b.any(0))
    if not rows.size:
        return out
    m = max(kernel.shape)
    y0, y1 = max(rows[0] - m, 0), min(rows[-1] + m + 1, b.shape[0])
    x0, x1 = max(cols[0] - m, 0), min(cols[-1] + m + 1, b.shape[1])
    out[y0:y1, x0:x1] = _dilate_runs(b[y0:y1, x0:x1], kernel)
    return out


def _dilate_runs(b: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``_dilate_disk`` over the whole map: each kernel row is one run of
    pixels, so the dilation is the OR over the rows of a run dilation of
    ``b`` (from row prefix sums) shifted by the row's offset."""
    h, w = b.shape
    ay, ax = kernel.shape[0] // 2, kernel.shape[1] // 2
    r = kernel.shape[1]
    # prefix sums along each row, r columns of edge values on both sides:
    # pre[:, r + j] = number of set pixels in columns < j, clamped to [0, w]
    pre = np.empty((h, w + 1 + 2 * r), np.int32)
    np.cumsum(b, axis=1, dtype=np.int32, out=pre[:, r + 1:r + w + 1])
    pre[:, :r + 1] = 0
    pre[:, r + w + 1:] = pre[:, r + w:r + w + 1]
    runs = {}
    out = np.zeros((h, w), bool)
    for ky, row in enumerate(kernel):
        nz = np.flatnonzero(row)
        dy = ky - ay
        if not nz.size or abs(dy) >= h:
            continue
        lo, hi = int(nz[0]) - ax, int(nz[-1]) - ax     # the row's one run of pixels
        if (lo, hi) not in runs:
            # any set pixel in columns [x + lo, x + hi]
            runs[lo, hi] = pre[:, r + hi + 1:r + hi + 1 + w] > pre[:, r + lo:r + lo + w]
        run = runs[lo, hi]
        # out[y] |= run[y + dy]
        if dy >= 0:
            out[:h - dy] |= run[dy:]
        else:
            out[-dy:] |= run[:h + dy]
    return out


def f_measure(foreground_mask: np.ndarray, gt_mask: np.ndarray,
              void_pixels: np.ndarray | None = None,
              bound_th: float = 0.008) -> float:
    """Boundary F for one frame (davis2017/metrics.py:57-119).

    Boundaries of ``mask & ~void`` are matched within a ``disk(bound_pix)``
    dilation; precision over predicted-boundary pixels, recall over
    GT-boundary pixels.
    """
    assert foreground_mask.ndim == 2
    if void_pixels is not None:
        valid = ~(void_pixels > 0.5)
    else:
        valid = np.ones(foreground_mask.shape, bool)

    bound_pix = bound_th if bound_th >= 1 else \
        np.ceil(bound_th * np.linalg.norm(foreground_mask.shape))

    fg_boundary = _seg2bmap((foreground_mask > 0.5) & valid)
    gt_boundary = _seg2bmap((gt_mask > 0.5) & valid)

    kernel = _disk(bound_pix)
    fg_dil = _dilate_disk(fg_boundary, kernel)
    gt_dil = _dilate_disk(gt_boundary, kernel)

    gt_match = gt_boundary & fg_dil
    fg_match = fg_boundary & gt_dil
    n_fg = int(fg_boundary.sum())
    n_gt = int(gt_boundary.sum())

    # Edge-case table from davis2017/metrics.py:100-117.
    if n_fg == 0 and n_gt > 0:
        return 0.0           # precision 1, recall 0
    if n_fg > 0 and n_gt == 0:
        return 0.0           # precision 0, recall 1
    if n_fg == 0 and n_gt == 0:
        return 1.0           # precision 1, recall 1
    precision = fg_match.sum() / n_fg
    recall = gt_match.sum() / n_gt
    if precision + recall == 0:
        return 0.0
    return 2.0 * precision * recall / (precision + recall)


def db_eval_boundary(annotation: np.ndarray, segmentation: np.ndarray,
                     void_pixels: np.ndarray | None = None,
                     bound_th: float = 0.008) -> np.ndarray:
    """Boundary measure F per frame (davis2017/metrics.py:40-54); inputs
    (T, H, W) or (H, W); optional per-frame void masks of the same shape."""
    assert annotation.shape == segmentation.shape
    if void_pixels is not None:
        assert void_pixels.shape == annotation.shape
    if annotation.ndim == 2:
        return np.asarray(
            f_measure(segmentation, annotation, void_pixels, bound_th))
    fs = [
        f_measure(segmentation[t], annotation[t],
                  None if void_pixels is None else void_pixels[t], bound_th)
        for t in range(annotation.shape[0])
    ]
    return np.asarray(fs)
