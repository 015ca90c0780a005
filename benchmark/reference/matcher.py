"""Per-video query <-> target assignment: counterpart of
``ocpg_tpu/models/matcher.py``.

Each video carries one object, so the assignment is an argmin over queries
of the per-video cost: a focal class cost averaged over the valid frames
only, L1 and GIoU box costs averaged over all frames, and focal and dice
mask costs against the target masks taken at every ``mask_out_stride``-th
pixel from offset ``stride // 2``.  It runs under ``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .box_ops import box_cxcywh_to_xyxy, generalized_box_iou_aligned


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    cost_class: float = 2.0
    cost_bbox: float = 5.0
    cost_giou: float = 2.0
    cost_mask: float = 2.0
    cost_dice: float = 5.0
    num_classes: int = 1
    mask_out_stride: int = 2


def matcher_config(cfg) -> MatcherConfig:
    """The matcher's costs from an ``OCPGConfig``."""
    return MatcherConfig(cost_class=cfg.set_cost_class, cost_bbox=cfg.set_cost_bbox,
                         cost_giou=cfg.set_cost_giou, cost_mask=cfg.set_cost_mask,
                         cost_dice=cfg.set_cost_dice, num_classes=cfg.num_classes)


@torch.no_grad()
def match(cfg: MatcherConfig,
          pred_logits: torch.Tensor,   # (B, T, Q, K)
          pred_boxes: torch.Tensor,    # (B, T, Q, 4) cxcywh in [0, 1]
          pred_masks: torch.Tensor,    # (B, T, Q, H2, W2) logits at 1/2 resolution
          tgt_labels: torch.Tensor,    # (B, T) int
          tgt_boxes: torch.Tensor,     # (B, T, 4) cxcywh
          tgt_masks: torch.Tensor,     # (B, T, H, W) binary, full (padded) resolution
          tgt_valid: torch.Tensor,     # (B, T) {0, 1}
          ) -> torch.Tensor:           # (B,) matched query index
    b, t, q, k = pred_logits.shape
    alpha, gamma = 0.25, 2.0
    s = cfg.mask_out_stride
    tm = tgt_masks[:, :, s // 2::s, s // 2::s].float().reshape(b, 1, -1)   # (B, 1, THW)

    prob = torch.sigmoid(pred_logits.float())
    neg_cost = (1 - alpha) * prob ** gamma * -torch.log(1 - prob + 1e-8)
    pos_cost = alpha * (1 - prob) ** gamma * -torch.log(prob + 1e-8)
    if cfg.num_classes == 1:
        cost_class_t = pos_cost[..., 0] - neg_cost[..., 0]                 # (B, T, Q)
    else:
        cls = tgt_labels.long().clamp(0, k - 1)[:, :, None, None].expand(b, t, q, 1)
        cost_class_t = torch.gather(pos_cost - neg_cost, -1, cls)[..., 0]
    valid = tgt_valid.float()
    cost_class = ((cost_class_t * valid[:, :, None]).sum(1)
                  / valid.sum(1, keepdim=True).clamp(min=1.0))             # (B, Q)

    boxes = pred_boxes.float()
    cost_bbox = (boxes - tgt_boxes[:, :, None, :]).abs().sum(-1).mean(1)
    giou = generalized_box_iou_aligned(box_cxcywh_to_xyxy(boxes),
                                       box_cxcywh_to_xyxy(tgt_boxes)[:, :, None, :])
    cost_giou = (-giou).mean(1)

    pm = pred_masks.float().transpose(1, 2).reshape(b, q, -1)              # (B, Q, THW)
    prob_m = torch.sigmoid(pm)
    ce = F.relu(pm) - pm * tm + torch.log1p(torch.exp(-pm.abs()))
    p_t = prob_m * tm + (1 - prob_m) * (1 - tm)
    alpha_t = alpha * tm + (1 - alpha) * (1 - tm)
    cost_mask = (alpha_t * (ce * (1 - p_t) ** gamma)).mean(-1)
    cost_dice = -(2 * (prob_m * tm).sum(-1) + 1) / (prob_m.sum(-1) + tm.sum(-1) + 1)

    cost = (cfg.cost_class * cost_class + cfg.cost_bbox * cost_bbox
            + cfg.cost_giou * cost_giou + cfg.cost_mask * cost_mask
            + cfg.cost_dice * cost_dice)
    return cost.argmin(-1)
