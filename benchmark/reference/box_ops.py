"""Box utilities: counterpart of ``ocpg_tpu/utils/box_ops.py`` (cxcywh ->
xyxy, areas, elementwise GIoU of aligned boxes)."""

from __future__ import annotations

from typing import Tuple

import torch


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], -1)


def box_area(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def box_iou_aligned(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Elementwise IoU of aligned (broadcastable) xyxy boxes; returns (iou, union)."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a) + box_area(b) - inter
    return inter / union.clamp(min=1e-6), union


def generalized_box_iou_aligned(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise GIoU of aligned (broadcastable) xyxy boxes."""
    iou, union = box_iou_aligned(a, b)
    lt = torch.minimum(a[..., :2], b[..., :2])
    rb = torch.maximum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area.clamp(min=1e-6)
