"""Dynamic-conv mask head and the MSO mask refiner: counterparts of
``ocpg_tpu/models/mask_head.py``.

``apply_dynamic_conv_shared`` keeps the JAX function's channels-last
layouts; ``MSO`` takes NCHW maps.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .image import bilinear_resize


def dynamic_params_layout(in_channels: int, channels: int, num_layers: int,
                          rel_coord: bool) -> Tuple[List[int], List[int]]:
    """weight_nums / bias_nums of the controller's output."""
    weight_nums, bias_nums = [], []
    for l in range(num_layers):
        if l == 0:
            cin = in_channels + 2 if rel_coord else in_channels
            weight_nums.append(cin * channels)
        else:
            weight_nums.append(channels * channels)
        bias_nums.append(channels)
    return weight_nums, bias_nums


def compute_locations(h: int, w: int, stride: int, device=None) -> torch.Tensor:
    """Pixel-centre grid in image coordinates, (h, w, 2) as xy."""
    shift_x = torch.arange(w, dtype=torch.float32, device=device) * stride + stride // 2
    shift_y = torch.arange(h, dtype=torch.float32, device=device) * stride + stride // 2
    return torch.stack((shift_x[None, :].expand(h, w), shift_y[:, None].expand(h, w)), -1)


def apply_dynamic_conv_shared(
    mem: torch.Tensor,       # (G, H, W, C)   shared by the Q queries of each group
    rel: torch.Tensor,       # (G, Q, H, W, 2) per-query relative coordinates
    params: torch.Tensor,    # (G, Q, num_params) controller outputs
    channels: int,
    weight_nums: Sequence[int],
    bias_nums: Sequence[int],
) -> torch.Tensor:           # (G, Q, H, W, channels)
    """Per-query 1x1 conv stack whose first layer's input is split into the
    query-shared memory and the per-query rel-coord planes, so the Q-fold
    broadcast of the memory is never materialised."""
    g, q = params.shape[:2]
    num_layers = len(weight_nums)
    c = mem.shape[-1]
    sizes = list(weight_nums) + list(bias_nums)
    splits = torch.split(params, sizes, dim=-1)
    weights, biases = splits[:num_layers], splits[num_layers:]

    cin0 = weight_nums[0] // channels
    w1 = weights[0].reshape(g, q, channels, cin0)
    b1 = biases[0].reshape(g, q, channels)
    if cin0 == c + 2:
        x = (torch.einsum("ghwc,gqoc->gqhwo", mem, w1[..., :c])
             + torch.einsum("gqhwr,gqor->gqhwo", rel, w1[..., c:])
             + b1[:, :, None, None, :])
    elif cin0 == c:
        x = torch.einsum("ghwc,gqoc->gqhwo", mem, w1) + b1[:, :, None, None, :]
    else:
        raise ValueError(f"first dynamic layer takes {cin0} channels, memory has {c}")
    for l in range(1, num_layers):
        x = F.relu(x)
        w = weights[l].reshape(g, q, channels, channels)
        b = biases[l].reshape(g, q, channels)
        x = torch.einsum("gqhwc,gqoc->gqhwo", x, w) + b[:, :, None, None, :]
    return x


class _ConcatConv(nn.Conv2d):
    """3x3 conv over ``cat([a, b], channels)`` whose ``b`` may be shared by Q
    consecutive groups of ``a``.  With ``queries > 1`` the conv is split by
    linearity and the b-half runs once per group.  Its weight is the full
    (features, ca + cb, 3, 3) kernel of one conv over the concatenation."""

    def __init__(self, features: int, ca: int, cb: int):
        super().__init__(ca + cb, features, 3, padding=1)
        self.ca = ca

    def forward(self, a: torch.Tensor, b: torch.Tensor, queries: int = 1) -> torch.Tensor:
        if queries == 1:
            return super().forward(torch.cat([a, b.to(a.dtype)], 1))
        g = b.shape[0]
        if a.shape[0] != g * queries:
            raise ValueError(f"{a.shape[0]} per-query maps for {g} groups x {queries}")
        ya = F.conv2d(a, self.weight[:, :self.ca], padding=1)
        yb = F.conv2d(b, self.weight[:, self.ca:], padding=1)
        ya = ya.reshape(g, queries, *ya.shape[1:])
        return (ya + yb[:, None] + self.bias[:, None, None]).reshape(
            g * queries, *ya.shape[2:])


class MSO(nn.Module):
    """Multi-scale mask refiner on NCHW maps.  ``queries > 1`` marks
    feat_4x / feat_8x as shared by Q consecutive pred_masks (group-major)."""

    def __init__(self, mask_dim: int = 16, img_dims: Tuple[int, int] = (256, 512)):
        super().__init__()
        self.conv1_1div8 = _ConcatConv(mask_dim, mask_dim, img_dims[1])
        self.conv2_1div8 = nn.Conv2d(mask_dim, mask_dim, 3, padding=1)
        self.conv1_1div4 = _ConcatConv(mask_dim, mask_dim, img_dims[0])
        self.conv2_1div4 = nn.Conv2d(mask_dim, mask_dim, 3, padding=1)
        self.out_conv = nn.Conv2d(mask_dim, 1, 3, padding=1)

    def forward(self, pred_masks: torch.Tensor, feat_4x: torch.Tensor,
                feat_8x: torch.Tensor, queries: int = 1) -> torch.Tensor:
        x = F.relu(self.conv1_1div8(F.relu(pred_masks),
                                    F.relu(feat_8x.to(pred_masks.dtype)), queries))
        pred_masks = pred_masks + self.conv2_1div8(x)
        pred_masks = bilinear_resize(pred_masks, tuple(feat_4x.shape[-2:]),
                                     align_corners=False)
        x = F.relu(self.conv1_1div4(F.relu(pred_masks),
                                    F.relu(feat_4x.to(pred_masks.dtype)), queries))
        pred_masks = pred_masks + self.conv2_1div4(x)
        return self.out_conv(pred_masks)
