"""Image resampling ops: counterparts of ``ocpg_tpu/ops/image.py``.

Unlike the JAX functions, which take NHWC, these take NCHW tensors, as
``F.interpolate`` does.  Nearest, bicubic and bilinear with
``align_corners=False`` are ``F.interpolate`` itself.  Bilinear with
``align_corners=True`` applies two separable ``(out, in)`` matrices built on
the host in float64, as the JAX package does: ``F.interpolate`` computes that
source coordinate in float32, which moves a weight by a float32 ulp of a
coordinate near 100.  Like the JAX functions, these compute in their input's
dtype: autocast, which would run the resizes in float32, is off inside them.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _interpolate(x: torch.Tensor, size: Tuple[int, int], **kw) -> torch.Tensor:
    with torch.autocast(device_type=x.device.type, enabled=False):
        return F.interpolate(x, size=tuple(size), **kw)


@functools.lru_cache(maxsize=None)
def _align_corners_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense (out_size, in_size) bilinear matrix with align_corners=True: the
    source coordinate in float64, the weights stored in float32 (the JAX
    package's ``_resize_matrix``)."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    scale = (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
    src = np.arange(out_size) * scale
    x0 = np.floor(src).astype(np.int64)
    dx = src - x0
    for off, w in ((0, 1.0 - dx), (1, dx)):
        np.add.at(m, (np.arange(out_size), np.clip(x0 + off, 0, in_size - 1)), w)
    return m


@functools.lru_cache(maxsize=64)
def _matrix_on(in_size: int, out_size: int, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(_align_corners_matrix(in_size, out_size)).to(device, dtype)


def nearest_resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """torch legacy 'nearest': src = floor(dst * in / out)."""
    return _interpolate(x, size, mode="nearest")


def bilinear_resize(x: torch.Tensor, size: Tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    if tuple(size) == tuple(x.shape[-2:]):
        return x
    if not align_corners:
        return _interpolate(x, size, mode="bilinear", align_corners=False)
    (h, w), (oh, ow) = x.shape[-2:], size
    mh = _matrix_on(h, oh, x.device, x.dtype)
    mw = _matrix_on(w, ow, x.device, x.dtype)
    with torch.autocast(device_type=x.device.type, enabled=False):
        return torch.matmul(torch.matmul(mh, x), mw.t())


def bicubic_resize(x: torch.Tensor, size: Tuple[int, int],
                   align_corners: bool = False) -> torch.Tensor:
    """Cubic convolution with a = -0.75, borders clamped (torch's bicubic)."""
    if tuple(size) == tuple(x.shape[-2:]):
        return x
    return _interpolate(x, size, mode="bicubic", align_corners=align_corners)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """out[n, c, h*r+i, w*r+j] = in[n, c*r*r + i*r + j, h, w]."""
    return F.pixel_shuffle(x, r)
