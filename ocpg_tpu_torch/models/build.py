"""Model factory: counterpart of ``ocpg_tpu/models/build.py``.

``build_model`` returns the model alone; the train step's pieces come from
``build_weight_dict``, ``matcher_config`` and ``criterion_config``.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Optional, Union

import torch
import torch.nn as nn

from ..config import OCPGConfig
from ..utils.profiling import span
from .backbone_video_swin import WindowAttention3D
from .criterion import CriterionConfig
from .deformable_transformer import offset_bias
from .matcher import matcher_config
from .ocpg import OCPG

__all__ = ["build_model", "build_weight_dict", "criterion_config", "init_modules",
           "init_params", "matcher_config", "resolve_device"]


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


# flax's lecun_normal: variance_scaling(1, "fan_in", "truncated_normal"), a
# normal cut at +-2 and rescaled by this constant so its std stays 1/sqrt(fan_in)
_TRUNC_STD = 0.87962566103423978

# The initialiser of each Linear and Conv2d weight, by the module's own name
# with its digits written "#" (the names follow the flax tree).  "xavier" is
# where the JAX modules pass ``kernel_init=xavier_uniform``
# (ocpg_tpu/models/layers.py, deformable_transformer.py, ocpg.py's
# input_proj_# and ls_feat_viz), "lecun" flax's default, "zeros" the MSDA
# offset and attention-weight heads.
_WEIGHT_INIT = {
    # MultiheadAttention, the MSDA projections, the FFNs and the MLPs
    "q_proj": "xavier", "k_proj": "xavier", "v_proj": "xavier", "out_proj": "xavier",
    "value_proj": "xavier", "output_proj": "xavier", "linear#": "xavier",
    "reference_points": "xavier", "layers_#": "xavier",
    "input_proj_#": "xavier", "ls_feat_viz": "xavier",
    "sampling_offsets": "zeros", "attention_weights": "zeros",
    # the text encoder
    "q": "lecun", "k": "lecun", "v": "lecun", "attn_out": "lecun",
    "ffn_in": "lecun", "ffn_out": "lecun", "pooler": "lecun",
    # FeatureResizer, the LFM, the heads
    "fc": "lecun", "fc#": "lecun", "laplace": "lecun", "conv#": "lecun",
    "class_embed_#": "lecun", "ls_text_proj": "lecun",
    # the mask refiner
    "conv#_#div#": "lecun", "out_conv": "lecun",
    # ResNet
    "downsample_conv": "lecun",
    # the Swin backbones
    "qkv": "lecun", "proj": "lecun", "mlp_fc#": "lecun", "reduction": "lecun",
    "patch_embed": "lecun",
}


def _fans(weight: torch.Tensor):
    """flax's fans of the kernel that ``weight`` holds: Linear (out, in),
    Conv2d (out, in, kh, kw) with the receptive field in both."""
    field = weight[0, 0].numel()
    return weight.shape[1] * field, weight.shape[0] * field


def _init_weight(name: str, weight: torch.Tensor, g: torch.Generator) -> None:
    leaf = re.sub(r"\d+", "#", name.rsplit(".", 1)[-1])
    kind = _WEIGHT_INIT.get(leaf)
    fan_in, fan_out = _fans(weight)
    if kind == "xavier":
        a = math.sqrt(6.0 / (fan_in + fan_out))
        weight.uniform_(-a, a, generator=g)
    elif kind == "lecun":
        # N(0, 1) cut at +-2 by drawing the entries beyond it again (exact,
        # and faster on the CPU than nn.init.trunc_normal_'s inverse CDF)
        flat = weight.view(-1).normal_(generator=g)
        redraw = torch.nonzero(flat.abs() > 2.0).squeeze(1)
        while redraw.numel():
            draws = torch.empty(redraw.numel()).normal_(generator=g)
            flat[redraw] = draws
            redraw = redraw[draws.abs() > 2.0]
        weight.mul_(1.0 / math.sqrt(fan_in) / _TRUNC_STD)
    elif kind == "zeros":
        weight.zero_()
    else:
        raise KeyError(f"{name}: no JAX initialiser for {leaf!r}")


@torch.no_grad()
def init_modules(module: nn.Module, generator: torch.Generator) -> None:
    """Every Linear, Conv2d, Embedding and Swin bias table under ``module``
    drawn from ``generator`` with the JAX package's initialiser: the
    weights by ``_WEIGHT_INIT`` (xavier-uniform or flax's truncated
    lecun-normal; a name the table lacks raises), zero biases (but the Swin
    patch embedding's, the reference's uniform draw), embeddings at
    flax's ``default_embed_init`` (N(0, 1/features)), the bias tables
    truncated-normal with std 0.02 cut at 2 std.  LayerNorms, GroupNorms
    and the frozen BatchNorms keep their ones and zeros."""
    g = generator
    for name, mod in module.named_modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            _init_weight(name, mod.weight, g)
            if mod.bias is None:
                continue
            if name.rsplit(".", 1)[-1] == "patch_embed":
                # the one departure from JAX's zeros: the reference's Swin
                # keeps PyTorch's Conv3d default here, U(+-1/sqrt(fan_in)).
                # With a zero bias every canvas-padding token is the zero
                # vector, each LayerNorm over a wholly padded window sees no
                # variance, and its backward scales by 1/sqrt(eps) = 1000:
                # a full-depth Swin's gradients overflow on padded batches
                bound = 1.0 / math.sqrt(_fans(mod.weight)[0])
                mod.bias.uniform_(-bound, bound, generator=g)
            else:
                mod.bias.zero_()
        elif isinstance(mod, WindowAttention3D):
            nn.init.trunc_normal_(mod.relative_position_bias_table, std=0.02,
                                  a=-0.04, b=0.04, generator=g)
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.embedding_dim), generator=g)


@torch.no_grad()
def init_params(model: OCPG, generator: torch.Generator) -> None:
    """Random init from ``generator`` after the JAX package's initialisers:
    ``init_modules``, then N(0, 1) query and level embeddings and the MSDA
    offset grid, class prior and box-refinement biases."""
    g = generator
    init_modules(model, g)
    model.query_embed.normal_(0.0, 1.0, generator=g)
    tr = model.transformer
    tr.level_embed.normal_(0.0, 1.0, generator=g)
    for name, mod in model.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "sampling_offsets":
            parent = model.get_submodule(name.rsplit(".", 1)[0])
            mod.bias.copy_(torch.from_numpy(offset_bias(parent.m, parent.l, parent.p)))
        elif leaf.startswith("class_embed_"):
            mod.bias.fill_(-math.log((1 - 0.01) / 0.01))
    if tr.with_box_refine:
        for i in range(tr.num_decoder_layers):
            last = getattr(getattr(tr, f"bbox_embed_{i}"), "layers_2")
            last.weight.zero_()
            last.bias.zero_()
            if i == 0:
                last.bias[2:] = -2.0


def build_model(cfg: OCPGConfig, device: Optional[Union[str, torch.device]] = None,
                generator: Optional[torch.Generator] = None) -> OCPG:
    """The model on ``device`` (default: the GPU), in eval mode, with
    random weights drawn on the CPU from ``generator`` (default: seeded with
    ``cfg.seed``), so every device gets the same weights.  The construction
    and the draw are the kept span ``ocpg.init`` (``utils/profiling.py``)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    with span("ocpg.init", keep=True):
        model = OCPG(cfg)
        init_params(model, generator)
    return model.to(dev).eval()
