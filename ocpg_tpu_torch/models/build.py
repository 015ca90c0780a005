"""Model factory: counterpart of ``ocpg_tpu/models/build.py``.

``build_model`` returns the model alone; the train step's pieces come from
``build_weight_dict``, ``matcher_config`` and ``criterion_config``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Union

import torch
import torch.nn as nn

from ..config import OCPGConfig
from .criterion import CriterionConfig
from .deformable_transformer import offset_bias
from .matcher import matcher_config
from .ocpg import OCPG

__all__ = ["build_model", "build_weight_dict", "criterion_config", "init_params",
           "matcher_config", "resolve_device"]


def build_weight_dict(cfg: OCPGConfig) -> Dict[str, float]:
    """Loss name -> coefficient, with the entries of every aux decoder layer."""
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


def criterion_config(cfg: OCPGConfig) -> CriterionConfig:
    return CriterionConfig(num_classes=cfg.num_classes, focal_alpha=cfg.focal_alpha,
                           lst_warmup_iters=cfg.lst_warmup_iters, pairwise=cfg.pairwise_loss)


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``None`` means the GPU.  A CUDA device without a GPU raises: the
    port's entry points never carry on on the CPU unless asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' "
            "explicitly to run on the CPU")
    return dev


def init_params(model: OCPG, generator: torch.Generator) -> None:
    """Random init from ``generator`` after the JAX package's initialisers:
    xavier-uniform Linear weights, lecun-normal convolutions, zero biases,
    fan-in-normal embeddings, N(0, 1) query and level embeddings, and the
    MSDA, class-prior and box-refinement special cases."""
    g = generator
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Linear):
            fan_in, fan_out = mod.in_features, mod.out_features
            a = math.sqrt(6.0 / (fan_in + fan_out))
            mod.weight.data.uniform_(-a, a, generator=g)
            if mod.bias is not None:
                mod.bias.data.zero_()
        elif isinstance(mod, nn.Conv2d):
            fan_in = mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]
            mod.weight.data.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=g)
            if mod.bias is not None:
                mod.bias.data.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.data.normal_(0.0, 1.0 / math.sqrt(mod.embedding_dim), generator=g)
    model.query_embed.data.normal_(0.0, 1.0, generator=g)
    tr = model.transformer
    tr.level_embed.data.normal_(0.0, 1.0, generator=g)
    for name, mod in model.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "sampling_offsets":
            parent = model.get_submodule(name.rsplit(".", 1)[0])
            mod.weight.data.zero_()
            mod.bias.data.copy_(torch.from_numpy(offset_bias(parent.m, parent.l, parent.p)))
        elif leaf == "attention_weights":
            mod.weight.data.zero_()
        elif leaf.startswith("class_embed_"):
            mod.bias.data.fill_(-math.log((1 - 0.01) / 0.01))
    if tr.with_box_refine:
        for i in range(tr.num_decoder_layers):
            last = getattr(getattr(tr, f"bbox_embed_{i}"), "layers_2")
            last.weight.data.zero_()
            last.bias.data.zero_()
            if i == 0:
                last.bias.data[2:] = -2.0


def build_model(cfg: OCPGConfig, device: Optional[Union[str, torch.device]] = None,
                generator: Optional[torch.Generator] = None) -> OCPG:
    """The model on ``device`` (default: the GPU), in eval mode, with
    random weights drawn on the CPU from ``generator`` (default: seeded with
    ``cfg.seed``), so every device gets the same weights."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    model = OCPG(cfg)
    init_params(model, generator)
    return model.to(dev).eval()
