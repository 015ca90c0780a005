"""The reference train step and the reference serving forward.

* ``build_reference(fields, device)``: the OCPG model of a configuration
  file's fields, in float32 (whatever compute type the file states; the
  control asks for the file's own).
* ``ReferenceTrainStep``: decompress the compact batch, the train forward
  (matcher inside), the losses and their weighted total, the backward,
  the clip of every gradient by their global norm, then AdamW per group
  (the recipe's learning rates, betas (0.9, 0.999), eps 1e-8, the file's
  weight decay) when the total is finite.  Dropout and stochastic depth
  draw from a generator on the model's device seeded with the
  configuration's seed, as the program's step seeds its own, so the two
  draw the same masks when they run the same layers in the same order.
* ``reference_request``: one serving request padded to its canvas as the
  engine pads it, normalised, and run through the eval forward with every
  query's mask kept beside the query scores.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from .config import OCPGConfig
from . import layers
from .criterion import Blocks, CriterionConfig, compute_criterion
from .layers import set_dropout_generator
from .ocpg import OCPG
from .plain_ops import IMAGENET_MEAN, IMAGENET_STD

BETAS = (0.9, 0.999)
BLOCK_CLIPS = 2          # clips a block of the reference's train step holds


def _rows_of(batch: Mapping, rows: slice) -> Dict:
    return {k: _rows_of(v, rows) if isinstance(v, Mapping) else v[rows]
            for k, v in batch.items()}


def config_of(fields: Mapping) -> OCPGConfig:
    return OCPGConfig(**fields)


def build_reference(fields: Mapping, device, compute_dtype: str = "float32") -> OCPG:
    """The model of ``fields`` computing in ``compute_dtype`` (float32 unless
    the control asks for the configuration's own), weights uninitialised
    (load them)."""
    cfg = config_of(fields).replace(compute_dtype=compute_dtype)
    with torch.device("meta"):
        model = OCPG(cfg)
    return model.to_empty(device=device)


def weight_dict(cfg: OCPGConfig) -> Dict[str, float]:
    wd = {"loss_ce": cfg.cls_loss_coef, "loss_bbox": cfg.bbox_loss_coef,
          "loss_giou": cfg.giou_loss_coef}
    if cfg.masks:
        wd.update({"loss_mask": cfg.mask_loss_coef, "loss_proj": cfg.proj_loss_coef,
                   "loss_lst": cfg.lst_loss_coef, "loss_mask_low": cfg.mask_loss_coef,
                   "loss_proj_low": cfg.proj_loss_coef, "loss_lst_low": cfg.lst_loss_coef})
        if cfg.pairwise_loss:
            wd["loss_pairwise"] = cfg.pairwise_loss_coef
            wd["loss_pairwise_neighbor"] = cfg.pairwise_loss_coef
    if cfg.aux_loss:
        aux = {}
        for i in range(cfg.dec_layers - 1):
            aux.update({f"{k}_{i}": v for k, v in wd.items()})
        wd.update(aux)
    return wd


def group_label(cfg: OCPGConfig, name: str) -> str:
    """The recipe's parameter groups: the frozen text encoder and ResNet stem
    and layer1, the backbone, the MSDA sampling projections, the rest."""
    if "text_encoder" in name:
        return "frozen" if cfg.freeze_text_encoder else "text"
    if "backbone" in name:
        if cfg.freeze_video_encoder:
            return "frozen"
        if cfg.backbone.startswith("resnet") and not any(
                f"layer{i}" in name for i in (2, 3, 4)):
            return "frozen"
        return "backbone"
    if "reference_points" in name or "sampling_offsets" in name:
        return "proj"
    return "main"


def normalize_frames(samples: torch.Tensor, samples_mask: torch.Tensor) -> torch.Tensor:
    """uint8 RGB -> ImageNet-normalised float32, the padding zeroed again."""
    if samples.dtype != torch.uint8:
        return samples
    mean = torch.from_numpy(IMAGENET_MEAN).to(samples.device)
    std = torch.from_numpy(IMAGENET_STD).to(samples.device)
    x = (samples.float() / 255.0 - mean) / std
    return torch.where(samples_mask[..., None], 0.0, x)


def decompress(batch: Mapping, device) -> Dict:
    """The compact batch on ``device``, frames normalised, maps in float32."""
    def put(x):
        if isinstance(x, Mapping):
            return {k: put(v) for k, v in x.items()}
        return torch.as_tensor(x).to(device)

    b = put(batch)
    b["samples"] = normalize_frames(b["samples"], b["samples_mask"])
    t = b["targets"]
    for k in ("masks", "weights", "weak_masks"):
        if k in t:
            t[k] = t[k].float()
    return b


class ReferenceTrainStep:
    """One reference train step per call; returns the total loss."""

    def __init__(self, model: OCPG):
        cfg = model.cfg
        self.model, self.cfg = model, cfg
        self.device = next(model.parameters()).device
        lrs = {"main": cfg.lr, "backbone": cfg.lr_backbone, "text": cfg.lr_text_encoder,
               "proj": cfg.lr * cfg.lr_linear_proj_mult}
        groups: Dict[str, List[nn.Parameter]] = {}
        self.params: List[nn.Parameter] = []
        self.stepped: Dict[str, nn.Parameter] = {}
        for name, p in model.named_parameters():
            if "text_encoder" in name and cfg.freeze_text_encoder:
                p.requires_grad_(False)
            if not p.requires_grad:
                continue
            self.params.append(p)
            label = group_label(cfg, name)
            if label != "frozen":
                groups.setdefault(label, []).append(p)
                self.stepped[name] = p
        self.adamw = torch.optim.AdamW(
            [{"params": ps, "lr": lrs[k]} for k, ps in groups.items()],
            betas=BETAS, eps=1e-8, weight_decay=cfg.weight_decay)
        self.criterion_cfg = CriterionConfig(num_classes=cfg.num_classes,
                                             focal_alpha=cfg.focal_alpha,
                                             lst_warmup_iters=cfg.lst_warmup_iters,
                                             pairwise=cfg.pairwise_loss)
        self.weights = weight_dict(cfg)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        set_dropout_generator(model, self.generator)
        self.count = 0

    def __call__(self, batch: Mapping) -> float:
        """One step over the whole batch, run ``BLOCK_CLIPS`` clips at a time
        so that float32 fits: each block draws its rows of the whole batch's
        dropout masks from the same generator state, its loss is its share
        of the whole batch's (``criterion.Blocks``), and the gradients add
        up to the whole batch's."""
        model = self.model
        model.train(True)
        b = decompress(batch, self.device)
        for p in self.params:
            p.grad = None
        clips = b["samples"].shape[0]
        starts = list(range(0, clips, BLOCK_CLIPS))
        if clips % BLOCK_CLIPS and len(starts) > 1:
            raise ValueError(f"{clips} clips do not split into blocks of {BLOCK_CLIPS}")
        if self.cfg.pairwise_loss and len(starts) > 1:
            raise ValueError("the pairwise loss's weight masses are not split into blocks")
        stats = Blocks(b["targets"], len(starts)) if len(starts) > 1 else None
        state = self.generator.get_state()
        total = 0.0
        self.terms: Dict[str, float] = {}    # the step's loss terms, for a look
        self.matched: List[torch.Tensor] = []
        for start in starts:
            rows = slice(start, start + BLOCK_CLIPS)
            part = _rows_of(b, rows)
            self.generator.set_state(state)
            layers.BLOCK = (clips, start, part["samples"].shape[0]) if stats else None
            try:
                out = model(part["samples"], part["samples_mask"], part["text_ids"],
                            part["text_mask"], part["targets"]["size"],
                            targets=part["targets"], train=True)
            finally:
                layers.BLOCK = None
            loss, terms = compute_criterion(self.criterion_cfg, self.weights, out,
                                            part["targets"], self.count, mesh=stats)
            (loss / len(starts)).backward()
            total = total + loss.detach() / len(starts)
            for k, v in terms.items():
                self.terms[k] = self.terms.get(k, 0.0) + float(v.detach()) / len(starts)
            self.matched.append(out["matched"].detach())
            del out, loss
        with torch.no_grad():
            grads = [p.grad for p in self.params if p.grad is not None]
            norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
            scale = torch.where(norm < self.cfg.clip_max_norm, 1.0,
                                self.cfg.clip_max_norm / norm)
            for g in grads:
                g.mul_(scale)
        loss = float(total.detach())
        if np.isfinite(loss):
            self.adamw.step()
        self.count += 1
        return loss

    def first_grads(self) -> Dict[str, torch.Tensor]:
        """After one step: each stepped leaf's gradient as AdamW got it,
        from its first moment (exp_avg = (1 - beta1) g after one step)."""
        return {n: self.adamw.state[p]["exp_avg"] / (1.0 - BETAS[0])
                for n, p in self.stepped.items() if p in self.adamw.state}


@torch.no_grad()
def reference_request(model: OCPG, frames: np.ndarray, text_ids: np.ndarray,
                      text_mask: np.ndarray, canvas: Tuple[int, int],
                      clip_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every query's mask logits (Q, t, h, w) and each query's best class
    score averaged over the valid frames (Q,), for one request of ``t``
    frames of (h, w) uint8 RGB padded to ``clip_len`` frames of ``canvas``."""
    dev = next(model.parameters()).device
    t, h, w = frames.shape[:3]
    bh, bw = canvas
    samples = torch.zeros((1, clip_len, bh, bw, 3), dtype=torch.uint8, device=dev)
    samples[0, :t, :h, :w] = torch.from_numpy(frames).to(dev)
    mask = torch.ones((1, clip_len, bh, bw), dtype=torch.bool, device=dev)
    mask[0, :t, :h, :w] = False
    ids = torch.from_numpy(np.asarray(text_ids, np.int64))[None].to(dev)
    attn = torch.from_numpy(np.asarray(text_mask, np.int64))[None].to(dev)
    sizes = torch.tensor([[h, w]], dtype=torch.int32, device=dev)
    model.eval()
    out = model(normalize_frames(samples, mask), mask, ids, attn, sizes, every_query=True)
    masks = out["pred_masks"][0, :t, :, :h, :w].permute(1, 0, 2, 3).float()
    return masks, out["query_scores"][0].max(-1).values.float()
