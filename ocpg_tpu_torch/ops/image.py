"""Image resampling ops: counterparts of ``ocpg_tpu/ops/image.py``.

The JAX package builds separable resize matrices with torch's semantics;
here the same functions are ``F.interpolate`` and ``F.pixel_shuffle``
themselves.  Unlike the JAX functions, which take NHWC, these take NCHW
tensors, as ``F.interpolate`` does.  Like the JAX functions, they compute
in their input's dtype: autocast, which would run the resizes in float32,
is off inside them.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _interpolate(x: torch.Tensor, size: Tuple[int, int], **kw) -> torch.Tensor:
    with torch.autocast(device_type=x.device.type, enabled=False):
        return F.interpolate(x, size=tuple(size), **kw)


def nearest_resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """torch legacy 'nearest': src = floor(dst * in / out)."""
    return _interpolate(x, size, mode="nearest")


def bilinear_resize(x: torch.Tensor, size: Tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    if tuple(size) == tuple(x.shape[-2:]):
        return x
    return _interpolate(x, size, mode="bilinear", align_corners=align_corners)


def bicubic_resize(x: torch.Tensor, size: Tuple[int, int],
                   align_corners: bool = False) -> torch.Tensor:
    """Cubic convolution with a = -0.75, borders clamped (torch's bicubic)."""
    if tuple(size) == tuple(x.shape[-2:]):
        return x
    return _interpolate(x, size, mode="bicubic", align_corners=align_corners)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """out[n, c, h*r+i, w*r+j] = in[n, c*r*r + i*r + j, h, w]."""
    return F.pixel_shuffle(x, r)
