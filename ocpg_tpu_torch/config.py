"""Model configuration: a copy of ``ocpg_tpu/config.py`` for the port.

The fields and the presets (R101, Video Swin-T and -B) are those of the
JAX package, with four fields dropped because they select JAX machinery the
port does not have: ``msda_impl`` and ``swin_attn_impl`` (the port's MSDA
and Swin window attention dispatch on the tensor's device, see
``ops/ms_deform_attn.py`` and ``ops/window_attention.py``), ``prng_impl``
(JAX's PRNG) and ``data_parallel`` (the JAX mesh).  Passing any of them
raises.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class OCPGConfig:
    # * Backbone
    backbone: str = "resnet50"  # resnet50 | resnet101 | video_swin_{t,s,b}_p4w7 | swin_{t,s,b,l}_p4w7
    text_backbone: str = "roberta-base"
    text_layers: int = 12
    text_hidden: int = 768
    text_heads: int = 12
    text_ffn: int = 3072
    text_vocab: int = 50265
    text_max_pos: int = 514
    dilation: bool = False
    num_feature_levels: int = 4
    freeze_text_encoder: bool = True
    freeze_video_encoder: bool = False
    use_checkpoint: bool = False

    # * Transformer
    enc_layers: int = 4
    dec_layers: int = 4
    dim_feedforward: int = 2048
    hidden_dim: int = 256
    dropout: float = 0.1
    nheads: int = 8
    num_frames: int = 3
    num_queries: int = 5
    dec_n_points: int = 4
    enc_n_points: int = 4
    with_box_refine: bool = True
    two_stage: bool = False

    # * Segmentation
    masks: bool = True
    mask_dim: int = 256
    controller_layers: int = 2
    dynamic_mask_channels: int = 16
    rel_coord: bool = True

    # * Losses / matcher
    aux_loss: bool = True
    set_cost_class: float = 2.0
    set_cost_bbox: float = 5.0
    set_cost_giou: float = 2.0
    set_cost_mask: float = 2.0
    set_cost_dice: float = 5.0
    mask_loss_coef: float = 2.0
    dice_loss_coef: float = 5.0
    proj_loss_coef: float = 5.0
    lst_loss_coef: float = 2.0
    cls_loss_coef: float = 2.0
    bbox_loss_coef: float = 5.0
    giou_loss_coef: float = 2.0
    eos_coef: float = 0.1
    focal_alpha: float = 0.25
    lst_warmup_iters: int = 100_000
    pairwise_loss: bool = False
    pairwise_loss_coef: float = 1.0

    # * Dataset
    dataset_file: str = "ytvos"
    supervision: str = "box"  # full | box | point
    binary: bool = True
    max_size: int = 640
    max_skip: int = 3

    # * Optimization
    lr: float = 1e-4
    lr_backbone: float = 5e-5
    lr_text_encoder: float = 1e-5
    lr_linear_proj_mult: float = 1.0
    batch_size: int = 1
    weight_decay: float = 5e-4
    epochs: int = 10
    lr_drop: Tuple[int, ...] = (6, 8)
    clip_max_norm: float = 0.1

    # * Numerics: "bfloat16" runs the model under torch.autocast with float32
    # islands where the JAX modules fix float32; "float32" runs it all in f32
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"

    seed: int = 42

    @property
    def num_classes(self) -> int:
        if self.binary:
            return 1
        return {"ytvos": 65, "davis": 78, "a2d": 1, "jhmdb": 1}.get(self.dataset_file, 91)

    def replace(self, **kw) -> "OCPGConfig":
        return dataclasses.replace(self, **kw)


def a2d_r101_boxsup() -> OCPGConfig:
    return OCPGConfig(backbone="resnet101", dataset_file="a2d", supervision="box",
                      epochs=12, lr_drop=(3, 5), num_frames=3)


def ytvos_r101_boxsup() -> OCPGConfig:
    return OCPGConfig(backbone="resnet101", dataset_file="ytvos", supervision="box",
                      epochs=10, lr_drop=(6, 8), num_frames=3)


def a2d_videoswin_tiny() -> OCPGConfig:
    return OCPGConfig(backbone="video_swin_t_p4w7", dataset_file="a2d", epochs=12,
                      lr_drop=(3, 5))


def davis_videoswin_base() -> OCPGConfig:
    return OCPGConfig(backbone="video_swin_b_p4w7", dataset_file="davis", epochs=10)
