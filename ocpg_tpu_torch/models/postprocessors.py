"""Prediction postprocessing to evaluation formats: counterpart of
``ocpg_tpu/models/postprocessors.py``.

* A2D/JHMDB: per-frame sigmoid scores, unpad, bilinear resize to the
  original size, RLE.  The reference inverts the mask, ``1 - (sigmoid >
  0.5)``; here the mask is not inverted unless ``invert_masks`` asks for
  the quirk.
* RefCOCO: the scored boxes in absolute xyxy.

The resize is ``ops/image.bilinear_resize`` (NCHW, two float32 products)
on the CPU: the masks are thresholded at logit 0, so a pixel whose resized
logit is within rounding of 0 flips under a less precise product.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..evaluation.rle import rle_encode
from ..ops.image import bilinear_resize


def refcoco_postprocess(
    pred_logits: np.ndarray,      # (B, T=1, Q, K)
    pred_boxes: np.ndarray,       # (B, T=1, Q, 4) cxcywh normalized
    orig_sizes: Sequence[Tuple[int, int]],  # (h, w) per sample
) -> List[Dict]:
    """Scored boxes in absolute xyxy, highest score first."""
    out = []
    scores = 1.0 / (1.0 + np.exp(-pred_logits[:, 0, :, :]))  # (B, Q, K)
    for i in range(pred_logits.shape[0]):
        s = scores[i].max(axis=-1)
        labels = scores[i].argmax(axis=-1)
        cx, cy, w, h = np.split(pred_boxes[i, 0], 4, axis=-1)
        oh, ow = orig_sizes[i]
        boxes = np.concatenate(
            [(cx - w / 2) * ow, (cy - h / 2) * oh, (cx + w / 2) * ow, (cy + h / 2) * oh],
            axis=-1)
        order = np.argsort(-s)
        out.append({"scores": s[order], "labels": labels[order], "boxes": boxes[order]})
    return out


def a2d_postprocess(
    pred_logits: np.ndarray,      # (B, T, Q, K): T = 1 valid frame
    pred_masks: np.ndarray,       # (B, T, Q, H, W) logits on the padded canvas
    resized_sizes: Sequence[Tuple[int, int]],  # pre-padding (h, w) per sample
    orig_sizes: Sequence[Tuple[int, int]],     # dataset-native (h, w) per sample
    invert_masks: bool = False,
) -> List[Dict]:
    """Returns [{scores (Q,), rle_masks [Q]}] per batch element."""
    out = []
    scores_all = 1.0 / (1.0 + np.exp(-pred_logits[:, 0, :, 0]))
    for i in range(pred_logits.shape[0]):
        h, w = resized_sizes[i]
        masks = torch.from_numpy(np.ascontiguousarray(pred_masks[i, 0, :, :h, :w],
                                                      np.float32))
        resized = bilinear_resize(masks[None], tuple(orig_sizes[i]),
                                  align_corners=False)[0].numpy()
        binary = (1.0 / (1.0 + np.exp(-resized))) > 0.5
        if invert_masks:
            binary = ~binary
        out.append({
            "scores": scores_all[i],
            "rle_masks": [rle_encode(m.astype(np.uint8)) for m in binary],
        })
    return out
