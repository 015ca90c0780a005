"""DenseCL-similarity pseudo-label model: counterpart of
``ocpg_tpu/preprocess/sim_model.py``.

A frozen ResNet-101 (DenseCL self-supervised weights in the reference)
gives layer4 features (stride 32, 2048 channels); each feature is
L2-normalised over its channels.  Two modes:

* point (``forward_point``): the cosine similarity of the feature at the
  annotated point against every feature, normalised per row as the
  reference does, ``(a - min) / max``;
* bbox (``forward_bbox``): up to ``MAX_QUERIES`` in-box query features on a
  strided grid, each query's similarity map scored by the IoU of its x and
  y max-projections against the box's, the best-scoring map kept.  The
  queries are padded to ``MAX_QUERIES`` (padded ones score -1) and scored
  with one ``(256, C) x (C, h*w)`` product, as in the JAX package.

The reference's arithmetic is kept as it is: the host's
``int(x / w_ori * w)`` box scaling, the exclusive-end box mask beside the
inclusive query grid, the strided grid loop, and the first index of the
argmax on ties.  On a GPU the convolutions and products run with TF32 off,
so the card computes in float32 as the CPU does.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..models.backbone_resnet import ResNet, build_resnet
from ..models.build import resolve_device

MAX_QUERIES = 256


def init_sim_model(arch: str = "resnet101", device: Optional[Union[str, torch.device]] = None,
                   seed: int = 0) -> ResNet:
    """The backbone (no dilation: layer4 at stride 32), float32, in eval
    mode on ``device`` (default: the GPU), its convolutions drawn from
    ``seed`` (lecun-normal, flax's default; FrozenBN at the identity).
    ``load_resnet_weights`` puts DenseCL weights in."""
    dev = resolve_device(device)
    model = build_resnet(arch, dilation=False)
    g = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, torch.nn.Conv2d):
            fan_in = mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]
            mod.weight.data.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=g)
    return model.to(dev).eval()


def load_resnet_weights(model: ResNet, state_dict) -> ResNet:
    """Load a torchvision-layout ResNet state dict (a DenseCL checkpoint)
    into ``model`` through ``utils/torch_weights.convert_resnet``; strict:
    a tensor the conversion leaves unset or a shape mismatch raises."""
    from ..utils.torch_weights import convert_resnet
    from ..utils.weights import load_jax_params

    params, frozen = convert_resnet(state_dict, model.layers)
    load_jax_params(model, {"params": params, "frozen": frozen})
    return model


@contextlib.contextmanager
def no_tf32():
    """TF32 off for cuDNN convolutions and matmuls inside (float32 as on the CPU)."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def image_keys(model: ResNet, image: torch.Tensor) -> torch.Tensor:
    """(1, 3, H, W) normalised image -> its layer4 features, each divided
    by its channel norm: (1, C, h, w)."""
    with torch.no_grad(), no_tf32():
        feat = model(image)[-1]
        return feat / torch.linalg.vector_norm(feat, dim=1, keepdim=True)


def _minmax_rows(attn: torch.Tensor) -> torch.Tensor:
    amin = attn.amin(dim=-1, keepdim=True)
    amax = attn.amax(dim=-1, keepdim=True)
    # the reference normalises as (a - min) / max
    return (attn - amin) / torch.where(amax == 0, torch.ones_like(amax), amax)


def point_heat(keys: torch.Tensor, point_xy_norm: Tuple[float, float]) -> np.ndarray:
    """The point mode on precomputed ``image_keys``: (h, w) soft mask."""
    b, c, h, w = keys.shape
    px = min(max(int(point_xy_norm[0] * w), 0), w - 1)
    py = min(max(int(point_xy_norm[1] * h), 0), h - 1)
    with torch.no_grad(), no_tf32():
        q = keys[:, :, py, px]                                   # (1, C)
        attn = torch.einsum("bc,bchw->bhw", q, keys).reshape(b, -1)
        return _minmax_rows(attn).reshape(h, w).cpu().numpy()


def bbox_scores(keys: torch.Tensor, box_xyxy_abs: Tuple[float, float, float, float],
                image_hw: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bbox mode's (MAX_QUERIES, h, w) normalised similarity maps and
    (MAX_QUERIES,) scores (padded queries score -1), on precomputed
    ``image_keys`` of an image of size ``image_hw``."""
    h_ori, w_ori = image_hw
    _, c, h, w = keys.shape
    x0 = int(box_xyxy_abs[0] / w_ori * w)
    y0 = int(box_xyxy_abs[1] / h_ori * h)
    x1 = int(box_xyxy_abs[2] / w_ori * w)
    y1 = int(box_xyxy_abs[3] / h_ori * h)
    x0, x1 = max(x0, 0), min(max(x1, x0), w - 1)
    y0, y1 = max(y0, 0), min(max(y1, y0), h - 1)

    # the strided in-box grid of at most MAX_QUERIES points
    range_x = list(range(x0, x1 + 1))
    range_y = list(range(y0, y1 + 1))
    i = 1
    while len(range_x) * len(range_y) > MAX_QUERIES:
        range_x = list(range(x0, x1 + 1, i + 1))
        range_y = list(range(y0, y1 + 1, i + 1))
        i += 1
    gx, gy = np.meshgrid(np.asarray(range_x), np.asarray(range_y), indexing="ij")
    locs = np.stack([gx.reshape(-1), gy.reshape(-1)], -1)       # (N, 2) xy
    n = len(locs)
    locs_p = np.concatenate([locs, np.zeros((MAX_QUERIES - n, 2), locs.dtype)], 0)
    dev = keys.device
    qmask = torch.zeros(MAX_QUERIES, device=dev)
    qmask[:n] = 1.0

    box_mask = np.zeros((h, w), np.float32)
    box_mask[y0:y1, x0:x1] = 1.0
    bm = torch.from_numpy(box_mask).to(dev)
    with torch.no_grad(), no_tf32():
        flat = keys[0].reshape(c, h * w)
        queries = flat[:, torch.from_numpy(locs_p[:, 1] * w + locs_p[:, 0]).to(dev)]
        attn = _minmax_rows(queries.T @ flat).reshape(MAX_QUERIES, h, w)
        attn_x = attn.amax(dim=-2)                               # (N, w)
        attn_y = attn.amax(dim=-1)                               # (N, h)
        bx = bm.amax(dim=-2)[None]
        by = bm.amax(dim=-1)[None]
        score_x = (attn_x * bx).sum(-1) / ((attn_x + bx - attn_x * bx).sum(-1) + 1e-5)
        score_y = (attn_y * by).sum(-1) / ((attn_y + by - attn_y * by).sum(-1) + 1e-5)
        score = (score_x + score_y) / 2 * qmask - (1 - qmask)
    return attn, score


def bbox_heat(keys: torch.Tensor, box_xyxy_abs: Tuple[float, float, float, float],
              image_hw: Tuple[int, int]) -> np.ndarray:
    """The bbox mode on precomputed ``image_keys``: the best query's (h, w)
    soft mask (the first best on ties)."""
    attn, score = bbox_scores(keys, box_xyxy_abs, image_hw)
    return attn[int(torch.argmax(score))].cpu().numpy()


def forward_point(model: ResNet, image: torch.Tensor,
                  point_xy_norm: Tuple[float, float]) -> np.ndarray:
    """image: (1, 3, H, W) normalised, on the model's device; point (x, y)
    in [0, 1].  Returns the (h, w) soft mask at stride 32."""
    return point_heat(image_keys(model, image), point_xy_norm)


def forward_bbox(model: ResNet, image: torch.Tensor,
                 box_xyxy_abs: Tuple[float, float, float, float]) -> np.ndarray:
    """image: (1, 3, H, W) normalised; box in image pixels.  Returns the
    best query's (h, w) soft mask at stride 32."""
    return bbox_heat(image_keys(model, image), box_xyxy_abs, tuple(image.shape[2:]))
