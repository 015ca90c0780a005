"""Optimizer: counterpart of ``ocpg_tpu/engine/optim.py``, the optax chain
``clip_by_global_norm(clip_max_norm)`` then ``multi_transform`` of AdamW
per parameter group with a multi-step schedule.

* ``param_group_label`` sorts the port's dotted parameter names (they
  follow the flax tree, so the JAX package's keywords apply) into "main",
  "backbone", "text", "proj" and "frozen".
* ``TrainOptimizer`` clips every gradient, the frozen group's too, by their
  global norm (as optax does before ``set_to_zero`` drops the frozen
  group), then steps ``torch.optim.AdamW`` over the other groups: betas
  (0.9, 0.999), eps 1e-8, the config's weight decay, and each group's lr
  times 0.1 at each boundary of ``lr_drop_steps``, counted in optimizer
  steps actually applied (optax's count, which a skipped step leaves).

The ResNet stem and ``layer1`` are "frozen" yet keep ``requires_grad``:
their gradients (through ``feat_4x`` into the mask refiner) enter the clip
norm and the reported ``grad_norm``, and no group updates them.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import torch
import torch.nn as nn

from ..config import OCPGConfig


def param_group_label(cfg: OCPGConfig, name: str) -> str:
    if "text_encoder" in name:
        return "frozen" if cfg.freeze_text_encoder else "text"
    if "backbone" in name:
        if cfg.freeze_video_encoder:
            return "frozen"
        # only layer2..layer4 of a ResNet train
        if cfg.backbone.startswith("resnet") and not any(
                f"layer{i}" in name for i in (2, 3, 4)):
            return "frozen"
        return "backbone"
    if "reference_points" in name or "sampling_offsets" in name:
        return "proj"
    return "main"


def multistep_lr(base_lr: float, lr_drop_steps: Sequence[int], count: int) -> float:
    """base_lr x 0.1 for every boundary at or below ``count``."""
    return base_lr * 0.1 ** sum(count >= b for b in lr_drop_steps)


class TrainOptimizer:
    """Global-norm clip over all gradients, then AdamW per group on a
    multi-step schedule (see the module docstring)."""

    def __init__(self, named_params: Iterable[Tuple[str, nn.Parameter]], cfg: OCPGConfig,
                 lr_drop_steps: Sequence[int] = ()):
        lrs = {"main": cfg.lr, "backbone": cfg.lr_backbone, "text": cfg.lr_text_encoder,
               "proj": cfg.lr * cfg.lr_linear_proj_mult}
        groups: Dict[str, List[nn.Parameter]] = {}
        self.params: List[nn.Parameter] = []
        for name, p in named_params:
            if not p.requires_grad:
                continue
            self.params.append(p)
            label = param_group_label(cfg, name)
            if label != "frozen":
                groups.setdefault(label, []).append(p)
        self.adamw = torch.optim.AdamW(
            [{"params": ps, "lr": lrs[k], "base_lr": lrs[k], "label": k}
             for k, ps in groups.items()],
            betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay)
        self.clip_max_norm = cfg.clip_max_norm
        self.lr_drop_steps = tuple(int(b) for b in lr_drop_steps)
        self.count = 0          # optimizer steps applied

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def clip_grads_(self) -> torch.Tensor:
        """Scales every gradient by clip_max_norm / norm when their global
        norm reaches clip_max_norm; returns the norm before the clip."""
        grads = [p.grad for p in self.params if p.grad is not None]
        if not grads:
            return torch.zeros(())
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < self.clip_max_norm, 1.0, self.clip_max_norm / norm)
        torch._foreach_mul_(grads, scale)
        return norm

    def step(self) -> None:
        for group in self.adamw.param_groups:
            group["lr"] = multistep_lr(group["base_lr"], self.lr_drop_steps, self.count)
        self.adamw.step()
        self.count += 1


def build_optimizer(model: nn.Module, cfg: OCPGConfig,
                    lr_drop_steps: Sequence[int] = ()) -> TrainOptimizer:
    """lr_drop_steps: the boundaries in optimizer steps."""
    return TrainOptimizer(model.named_parameters(), cfg, lr_drop_steps)
