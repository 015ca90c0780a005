"""Weak-supervision loss suite: counterpart of ``ocpg_tpu/models/criterion.py``.

* labels: sigmoid focal classification on valid frames, the matched
  (query, valid frame) slots positive, times ``T * Q``;
* boxes: L1 + GIoU of the matched query, all frames;
* masks: masked BCE against pseudo heatmaps (with the sigmoid-then-BCE-with-
  logits of the original), box-projection dice and the Chan-Vese level-set
  loss, at full and at 1/2 resolution, with a linear warmup over
  ``lst_warmup_iters`` steps that shifts weight from the BCE to the level set;
* with ``CriterionConfig.pairwise``, the BoxInst pairwise terms
  (``models/pairwise.py``) at 1/2 resolution.

The decoder layers are a Python loop (the JAX package vmaps them); the
last layer's losses have no suffix, the others ``_{layer}``.  Targets are
dense padded tensors: labels, valid (B, T), boxes (B, T, 4) cxcywh, masks,
weights (heatmaps), weak_masks (B, T, H, W) and size (B, 2).  Masks and
features keep the JAX layouts (NHWC for ``ls_features``).

Given a data mesh (``parallel/mesh.py``), each rank holds its rows of the
global batch, and the statistics that JAX takes over the whole sharded
batch are taken over every rank's rows: the box count ``num_boxes`` and
the pairwise weight masses are all-reduced sums of which each rank divides
by its share (``pairwise.normalizer``), and the heat-map weights' min and
max in ``masked_ce_loss`` are all-reduced.  The ``.mean()`` terms over
equal shards need nothing, so the ranks' mean loss and mean gradient are
the global batch's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .image import bilinear_resize, nearest_resize
from .box_ops import box_cxcywh_to_xyxy, generalized_box_iou_aligned
from .plain_ops import all_reduce_
from .pairwise import normalizer, pairwise_losses

Tensor = torch.Tensor


class Blocks:
    """The whole batch's statistics for a step that the reference runs in
    blocks of ``size`` equal row ranges (in the program's place, where
    the batch runs whole): the box count and the heat maps' weight range
    at full and half resolution, which ``masked_ce_loss`` and
    ``pairwise.normalizer`` read here instead of from the block's rows.
    Each block's loss is then its share of the whole batch's, and their
    mean is the whole batch's loss, as on a data mesh."""

    group = "blocks"

    def __init__(self, targets: Dict[str, Tensor], size: int, stride_low: int = 2):
        self.size = size
        self.num_boxes = targets["valid"].float().sum()
        w = (targets["weights"].float().clamp(0.3, 0.7) - 0.5).abs()
        st = stride_low // 2
        self.lohi = {}
        for x in (w, w[:, :, st::stride_low, st::stride_low]):
            self.lohi[tuple(x.shape[-2:])] = (x.min(), x.max())


@dataclasses.dataclass(frozen=True)
class CriterionConfig:
    num_classes: int = 1
    focal_alpha: float = 0.25
    lst_warmup_iters: int = 100_000
    mask_out_stride: int = 1
    mask_out_stride_low: int = 2
    pairwise: bool = False


def _bce_with_logits(logits: Tensor, targets: Tensor) -> Tensor:
    return F.relu(logits) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(inputs: Tensor, targets: Tensor, num_boxes: Tensor,
                       alpha: float = 0.25, gamma: float = 2.0) -> Tensor:
    """Mean over dim 1, sum over the rest, / num_boxes."""
    prob = torch.sigmoid(inputs)
    ce = _bce_with_logits(inputs, targets)
    p_t = prob * targets + (1 - prob) * (1 - targets)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss.mean(1).sum() / num_boxes


def dice_coefficient(x: Tensor, target: Tensor) -> Tensor:
    """Per-instance dice distance over the instances of dim 0."""
    n = x.shape[0]
    xf, tf = x.reshape(n, -1), target.reshape(n, -1)
    inter = (xf * tf).sum(1)
    union = (xf ** 2).sum(1) + (tf ** 2).sum(1) + 1e-5
    return 1.0 - 2.0 * inter / union


def masked_ce_loss(inputs: Tensor, weights: Tensor, masks: Tensor,
                   box_regions: Optional[Tensor] = None, alpha: float = 0.7,
                   beta: float = 0.3, thres: float = 0.5, mesh=None) -> Tensor:
    w = (weights.clamp(beta, alpha) - thres).abs()
    lo, hi = w.min(), w.max()
    if isinstance(mesh, Blocks):
        lo, hi = mesh.lohi[tuple(weights.shape[-2:])]
    elif mesh is not None and mesh.group is not None:
        neg_lo, hi = all_reduce_(mesh, torch.stack([-lo, hi]), "max")
        lo = -neg_lo
    w = (w - lo) / (hi - lo + 1e-5)
    if box_regions is not None:
        w = torch.where(box_regions == 0, 1.0, w)
    x = torch.sigmoid(inputs)          # sigmoid, then BCE with logits: as the original
    return _bce_with_logits(x * w, masks * w).mean()


def proj_loss(inputs: Tensor, box_regions: Tensor, masks: Tensor,
              with_mean_term: bool = True) -> Tensor:
    """Box-projection dice; inputs (B, T, H, W) logits."""
    x = torch.sigmoid(inputs)
    loss_y = dice_coefficient(x.amax(2, keepdim=True), box_regions.amax(2, keepdim=True))
    loss_x = dice_coefficient(x.amax(3, keepdim=True), box_regions.amax(3, keepdim=True))
    loss_max = (loss_y + loss_x).mean()
    loss_y = dice_coefficient(x.mean(2, keepdim=True), masks.mean(2, keepdim=True))
    loss_x = dice_coefficient(x.mean(3, keepdim=True), masks.mean(3, keepdim=True))
    loss_mean = (loss_y + loss_x).mean()
    return loss_max + 0.1 * loss_mean if with_mean_term else loss_max


def _length_regularization(mask_score: Tensor) -> Tensor:
    """Total-variation curve length of (N, C, H, W) maps."""
    gh = (mask_score[:, :, 1:, :] - mask_score[:, :, :-1, :]).abs()
    gw = (mask_score[:, :, :, 1:] - mask_score[:, :, :, :-1]).abs()
    return gh.sum((1, 2, 3)) + gw.sum((1, 2, 3))


def levelset_loss(mask_logits: Tensor, targets: Tensor, box_mask: Tensor) -> Tensor:
    """Chan-Vese level set; mask_logits (N, 1, H, W), targets (N, C, H, W),
    box_mask (N, 1, H, W)."""
    fg = torch.sigmoid(mask_logits)
    scores = torch.cat([fg, 1.0 - fg], 1)
    pixel_num = box_mask.sum((1, 2, 3)).clamp(min=1.0)
    phi = scores * box_mask
    tgt = targets * box_mask
    sf, sb = phi[:, 0:1], phi[:, 1:2]
    interior = (sf * tgt).sum((2, 3)) / sf.sum((2, 3)).clamp(min=1e-5)
    exterior = (sb * tgt).sum((2, 3)) / sb.sum((2, 3)).clamp(min=1e-5)
    region = ((tgt - interior[..., None, None]) ** 2 * sf
              + (tgt - exterior[..., None, None]) ** 2 * sb)
    region = region.sum((1, 2, 3)) / targets.shape[1]
    length = 1e-5 * _length_regularization(phi)
    return ((region + length) / pixel_num).mean()


def box_region_mask(boxes_xyxy_norm: Tensor, im_h: int, im_w: int, sizes: Tensor) -> Tensor:
    """Normalised xyxy boxes (N, 4), scaled to the unpadded (h, w) sizes
    (N, 2) and truncated toward zero, rasterised on the padded canvas."""
    hw = sizes.float()
    scale = torch.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]], -1)
    b = (boxes_xyxy_norm * scale).trunc()
    ys = torch.arange(im_h, dtype=torch.float32, device=b.device)[None, :, None]
    xs = torch.arange(im_w, dtype=torch.float32, device=b.device)[None, None, :]
    inside = ((ys >= b[:, 1, None, None]) & (ys < b[:, 3, None, None])
              & (xs >= b[:, 0, None, None]) & (xs < b[:, 2, None, None]))
    nonempty = ((b[:, 3] - b[:, 1]) > 0) & ((b[:, 2] - b[:, 0]) > 0)
    return inside.float() * nonempty[:, None, None].float()


def loss_labels(cfg: CriterionConfig, pred_logits: Tensor, tgt_labels: Tensor,
                tgt_valid: Tensor, matched_q: Tensor, num_boxes: Tensor) -> Tensor:
    """pred_logits (B, T, Q, K)."""
    b, t, q, k = pred_logits.shape
    logits = pred_logits.reshape(b, t * q, k).float()
    qs = torch.arange(q, device=logits.device)[None, None, :]
    pos = (tgt_valid[:, :, None] > 0) & (qs == matched_q[:, None, None])    # (B, T, Q)
    cls = (torch.zeros((b, t), dtype=torch.long, device=logits.device)
           if cfg.num_classes == 1 else tgt_labels.long())
    onehot = F.one_hot(cls, k).float()[:, :, None, :] * pos[..., None]
    onehot = onehot.reshape(b, t * q, k)
    return sigmoid_focal_loss(logits, onehot, num_boxes, alpha=cfg.focal_alpha) * (t * q)


def loss_boxes(pred_boxes_matched: Tensor, tgt_boxes: Tensor,
               num_boxes: Tensor) -> Tuple[Tensor, Tensor]:
    """(B, T, 4) cxcywh each."""
    src = pred_boxes_matched.reshape(-1, 4).float()
    tgt = tgt_boxes.reshape(-1, 4).float()
    l1 = (src - tgt).abs().sum() / num_boxes
    giou = generalized_box_iou_aligned(box_cxcywh_to_xyxy(src), box_cxcywh_to_xyxy(tgt))
    return l1, (1.0 - giou).sum() / num_boxes


def loss_masks(cfg: CriterionConfig,
               pred_masks: Tensor,       # (B, T, H, W) matched final mask logits
               pred_masks_low: Tensor,   # (B, T, H/2, W/2) matched patch logits
               ls_features: Tensor,      # (B, T, H/2, W/2, 12) [img3, feat8, sim1]
               tgt_heatmap: Tensor,      # (B, T, H, W)
               tgt_weakmask: Tensor,     # (B, T, H, W)
               tgt_boxes: Tensor,        # (B, T, 4) cxcywh normalised
               sizes: Tensor,            # (B, 2) actual (h, w)
               step: int, mesh=None) -> Dict[str, Tensor]:
    b, t, im_h, im_w = pred_masks.shape
    s_lo = cfg.mask_out_stride_low
    st = s_lo // 2
    heat_low = tgt_heatmap[:, :, st::s_lo, st::s_lo]
    weak_low = tgt_weakmask[:, :, st::s_lo, st::s_lo]
    boxes_xyxy = box_cxcywh_to_xyxy(tgt_boxes.reshape(-1, 4))
    region = box_region_mask(boxes_xyxy, im_h, im_w, sizes.repeat_interleave(t, 0))
    region = region.reshape(b, t, im_h, im_w)
    region_low = region[:, :, st::s_lo, st::s_lo]
    weak = tgt_weakmask * region
    weak_low = weak_low * region_low
    warmup = min(float(step) / cfg.lst_warmup_iters, 1.0)

    pm = pred_masks.float()
    pm_low = pred_masks_low.float()
    lm = masked_ce_loss(pm, tgt_heatmap, weak, region, mesh=mesh)
    lm_low = masked_ce_loss(pm_low, heat_low, weak_low, region_low, mesh=mesh)

    # level set at 1/2 resolution, without the similarity channel
    lh, lw = ls_features.shape[2], ls_features.shape[3]
    src = bilinear_resize(pm.reshape(b * t, 1, im_h, im_w), (lh, lw), align_corners=True)
    region_scaled = nearest_resize(region.reshape(b * t, 1, im_h, im_w), (lh, lw))
    lst_tgt = ls_features[..., :-1].reshape(b * t, lh, lw, -1).permute(0, 3, 1, 2).float()
    lst = levelset_loss(src, lst_tgt, region_scaled)
    lst_low = levelset_loss(pm_low.reshape(b * t, 1, lh, lw), lst_tgt, region_scaled)

    out = {
        "loss_proj": proj_loss(pm, region, weak, with_mean_term=True),
        "loss_mask": (1.0 - warmup) * lm,
        "loss_lst": warmup * lst,
        "loss_proj_low": proj_loss(pm_low, region_low, weak_low, with_mean_term=True),
        "loss_mask_low": (1.0 - warmup) * lm_low,
        "loss_lst_low": warmup * lst_low,
    }
    if cfg.pairwise:
        # the opt-in BoxInst terms at 1/2 resolution; the colors are the
        # level-set features' image channels (normalised RGB at that scale)
        out.update(pairwise_losses(pm_low, ls_features[..., :3], region_low, mesh=mesh))
    return out


def compute_criterion(cfg: CriterionConfig, weight_dict: Dict[str, float],
                      outputs: Dict[str, Tensor], targets: Dict[str, Tensor],
                      step: int, mesh=None) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The losses of every decoder layer and their weighted total.

    outputs: the train branch of ``OCPG.forward``: outputs_class and
    outputs_coord (L, B, T, Q, *), matched (L, B), pred_masks_layers
    (L, B, T, H, W), pred_masks_low_layers (L, B, T, H/2, W/2) and
    ls_features (B, T, H/2, W/2, 12).  step: the train step's counter (it
    drives the level-set warmup).  mesh: the data mesh whose ranks hold the
    rest of the batch (see the module docstring).
    """
    num_boxes = normalizer(targets["valid"].float().sum(), mesh)
    ldec = outputs["outputs_class"].shape[0]
    losses: Dict[str, Tensor] = {}
    for lvl in range(ldec):
        matched = outputs["matched"][lvl]
        layer = {"loss_ce": loss_labels(cfg, outputs["outputs_class"][lvl],
                                        targets["labels"], targets["valid"], matched,
                                        num_boxes)}
        coord = outputs["outputs_coord"][lvl]
        idx = matched[:, None, None, None].expand(coord.shape[0], coord.shape[1], 1, 4)
        layer["loss_bbox"], layer["loss_giou"] = loss_boxes(
            torch.gather(coord, 2, idx)[:, :, 0], targets["boxes"], num_boxes)
        layer.update(loss_masks(
            cfg, outputs["pred_masks_layers"][lvl], outputs["pred_masks_low_layers"][lvl],
            outputs["ls_features"], targets["weights"], targets["weak_masks"],
            targets["boxes"], targets["size"], step, mesh=mesh))
        suffix = "" if lvl == ldec - 1 else f"_{lvl}"
        losses.update({f"{k}{suffix}": v for k, v in layer.items()})
    # the JAX order: layer by layer, each layer's losses in the order above
    total = sum(losses[k] * weight_dict[k] for k in losses if k in weight_dict)
    return total, losses
