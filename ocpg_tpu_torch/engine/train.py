"""The train step: counterpart of ``ocpg_tpu/engine/train.py``.

``make_train_step`` (``TrainStep``) builds ``train_step(batch) -> metrics``, which
runs the forward with ``train=True`` (matcher inside), the
weak-supervision losses and their weighted total, the backward, the
global-norm clip over all gradients, and an AdamW step only if the total is
finite: a non-finite total leaves parameters and optimizer state as they
were (this costs one host sync per step).  The step counter, which drives
the level-set warmup, advances on every step, skipped ones too; the
learning-rate schedule counts only the optimizer steps applied
(``TrainOptimizer.count``).

Under a profiler the call marks its phases (``utils/profiling.py``):
``ocpg.step`` around it and, inside, ``ocpg.step.upload``, ``ocpg.loss``,
``ocpg.backward``, ``ocpg.optim.clip``, ``ocpg.step.readback`` (the host
sync) and ``ocpg.optim.step``; the forward marks its own.

Dropout and the Swin backbones' stochastic depth draw from a
``torch.Generator`` on the model's device that the step owns, seeded from
``cfg.seed``.  ``deterministic=True`` turns both off (``model.eval()``), as
JAX's ``deterministic=True``.  The counter and the generator's state are
the step's ``state_dict``, which a checkpoint holds beside the model's and
the optimizer's (``engine/checkpoint.py``).

The batch is the host dict of ``data/synthetic.py`` (and of the loaders),
or the same dict of tensors already on the device (``prefetch_to_mesh``):
frames, bool padding masks, int32 token ids, and the targets dict.  Every
array moves to the model's device as it is, so a compact batch (uint8
frames and masks, float16 heatmaps) crosses to the device in its compact
types and ``data/loader.py::decompress_batch`` expands it there; a float32
batch passes through.  With ``debug_images`` the metrics also carry
``debug_pred``, the sigmoid of the first clip's first-frame final mask, as a
host array.

``mesh`` (``parallel/mesh.py``) trains data-parallel, as the JAX step jitted
over a ``"data"`` mesh does: the batch is this rank's rows of the global
batch, the criterion's batch-global normalisers are taken over every rank
(``models/criterion.py``), and after the backward every gradient (the
frozen ones too, which enter the clip's norm) is averaged over the ranks in
one flat all-reduce (``TrainOptimizer.average_grads_``) before the clip and
AdamW.  The loss and its terms are the ranks' means, which are the global
batch's; ``finite`` is decided on that mean, so every rank skips together.
The dropout and stochastic-depth generator is seeded ``seed + rank``, as
the reference seeds each rank.  Replicate the parameters first
(``parallel/mesh.replicate``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from ..data.loader import decompress_batch
from ..models.criterion import CriterionConfig, compute_criterion
from ..models.layers import set_dropout_generator
from ..parallel.mesh import all_reduce_
from ..utils.profiling import span
from .optim import TrainOptimizer


def _to_device(x, device: torch.device):
    """Every leaf on ``device``: a tensor already there as it is (a batch
    from ``parallel/mesh.py::prefetch_to_mesh``), anything else copied."""
    if isinstance(x, Mapping):
        return {k: _to_device(v, device) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.to(device, non_blocking=True)
    return torch.as_tensor(np.asarray(x)).to(device, non_blocking=True)


class TrainStep:
    """One train step per call (see the module docstring).  ``state["step"]``
    is the step counter; ``generator`` is the dropout and stochastic-depth
    generator."""

    def __init__(self, model: nn.Module, criterion_cfg: CriterionConfig,
                 weight_dict: Dict[str, float], optimizer: TrainOptimizer,
                 has_valid_indices: bool = False, debug_images: bool = False,
                 deterministic: bool = False, mesh=None):
        self.model = model
        self.criterion_cfg = criterion_cfg
        self.weight_dict = weight_dict
        self.optimizer = optimizer
        self.has_valid_indices = has_valid_indices
        self.debug_images = debug_images
        self.deterministic = deterministic
        self.mesh = mesh
        self.device = next(model.parameters()).device
        rank = mesh.rank if mesh is not None else 0
        self.generator = torch.Generator(device=self.device).manual_seed(model.cfg.seed + rank)
        set_dropout_generator(model, self.generator)
        self.state = {"step": 0}

    def __call__(self, batch: Mapping) -> Dict[str, float]:
        with span("ocpg.step"):
            return self._step(batch)

    def _step(self, batch: Mapping) -> Dict[str, float]:
        model, optimizer = self.model, self.optimizer
        model.train(not self.deterministic)
        with span("ocpg.step.upload"):
            b = decompress_batch(_to_device(
                {k: v for k, v in batch.items()
                 if k != "valid_indices" or self.has_valid_indices}, self.device))
        optimizer.zero_grad()
        out = model(b["samples"], b["samples_mask"], b["text_ids"], b["text_mask"],
                    b["targets"]["size"], b.get("valid_indices"),
                    targets=b["targets"], train=True)
        with span("ocpg.loss"):
            total, losses = compute_criterion(self.criterion_cfg, self.weight_dict, out,
                                              b["targets"], self.state["step"], mesh=self.mesh)
        mesh = self.mesh if self.mesh is not None and self.mesh.group is not None else None
        with span("ocpg.backward"):
            total.backward()
            if mesh is not None:
                optimizer.average_grads_(mesh)
        with span("ocpg.optim.clip"):
            grad_norm = optimizer.clip_grads_()
        with span("ocpg.step.readback"):
            loss_values = torch.stack([total.detach(), *(v.detach() for v in losses.values())])
            if mesh is not None:
                loss_values = all_reduce_(mesh, loss_values) / mesh.size
            names = ["loss", "grad_norm", *losses]
            values = [loss_values[0], grad_norm.to(total.device), *loss_values[1:]]
            metrics = dict(zip(names, torch.stack(values).tolist()))
        finite = bool(np.isfinite(metrics["loss"]))
        if finite:
            with span("ocpg.optim.step"):
                optimizer.step()
        self.state["step"] += 1
        metrics["finite"] = float(finite)
        if self.debug_images:
            metrics["debug_pred"] = torch.sigmoid(
                out["pred_masks"][0, 0].detach().float()).cpu().numpy()
        return metrics

    def state_dict(self) -> Dict:
        return {"step": self.state["step"], "generator": self.generator.get_state()}

    def load_state_dict(self, state: Dict) -> None:
        self.state["step"] = int(state["step"])
        self.generator.set_state(state["generator"])


# the JAX package's name for the constructor
make_train_step = TrainStep
