"""The train step: counterpart of ``ocpg_tpu/engine/train.py``.

``make_train_step`` returns ``train_step(batch) -> metrics``, which runs the
forward with ``train=True`` (matcher inside), the weak-supervision losses
and their weighted total, the backward, the global-norm clip over all
gradients, and an AdamW step only if the total is finite: a non-finite
total leaves parameters and optimizer state as they were (this costs one
host sync per step).  The step counter, which drives the level-set warmup,
advances on every step, skipped ones too; the learning-rate schedule counts
only the optimizer steps applied (``TrainOptimizer.count``).

Dropout draws from a ``torch.Generator`` on the model's device that the
step owns, seeded from ``cfg.seed``.  ``deterministic=True`` turns dropout
off (``model.eval()``), as JAX's ``deterministic=True``.

The batch is the host dict of ``data/synthetic.py`` (and of the loaders):
float32 frames, bool padding masks, int32 token ids, and the targets dict;
every array moves to the model's device.  JAX's compact uint8 wire waits
for the loader.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from ..models.criterion import CriterionConfig, compute_criterion
from ..models.layers import set_dropout_generator
from .optim import TrainOptimizer


def _to_device(x, device: torch.device):
    if isinstance(x, Mapping):
        return {k: _to_device(v, device) for k, v in x.items()}
    return torch.as_tensor(np.asarray(x)).to(device, non_blocking=True)


def make_train_step(model: nn.Module, criterion_cfg: CriterionConfig,
                    weight_dict: Dict[str, float], optimizer: TrainOptimizer,
                    has_valid_indices: bool = False,
                    deterministic: bool = False) -> Callable[[Mapping], Dict[str, float]]:
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(model.cfg.seed)
    set_dropout_generator(model, generator)
    state = {"step": 0}

    def train_step(batch: Mapping) -> Dict[str, float]:
        model.train(not deterministic)
        b = _to_device({k: v for k, v in batch.items()
                        if k != "valid_indices" or has_valid_indices}, device)
        optimizer.zero_grad()
        out = model(b["samples"], b["samples_mask"], b["text_ids"], b["text_mask"],
                    b["targets"]["size"], b.get("valid_indices"),
                    targets=b["targets"], train=True)
        total, losses = compute_criterion(criterion_cfg, weight_dict, out, b["targets"],
                                          state["step"])
        total.backward()
        grad_norm = optimizer.clip_grads_()
        names = ["loss", "grad_norm", *losses]
        values = torch.stack([total.detach(), grad_norm.to(total.device),
                              *(v.detach() for v in losses.values())]).tolist()
        metrics = dict(zip(names, values))
        finite = bool(np.isfinite(metrics["loss"]))
        if finite:
            optimizer.step()
        state["step"] += 1
        metrics["finite"] = float(finite)
        return metrics

    train_step.state = state
    return train_step
