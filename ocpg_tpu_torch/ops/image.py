"""Image resampling ops: counterparts of ``ocpg_tpu/ops/image.py``.

Unlike the JAX functions, which take NHWC, these take NCHW tensors, as
``F.interpolate`` does.  Nearest is ``F.interpolate`` itself (exact).
Bilinear (both ``align_corners``) and bicubic apply two separable
``(out, in)`` matrices, built on the host in float64 and stored in float32,
as the JAX package does (``_resize_matrix``, ``_apply_separable``): first
over H, then over W.  In bfloat16 the matrices are rounded to bfloat16, each
pass multiplies with float32 accumulation and rounds its result to
bfloat16, so the rounding between the passes is the JAX function's; in
float32 both passes are float32 products (TF32 stays off, torch's default
for matmul).  The gradient is autograd through the two products.  Like the
JAX functions, these compute in their input's dtype: autocast, which would
run the resizes in float32, is off inside them.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _resize_matrix(in_size: int, out_size: int, mode: str, align_corners: bool) -> np.ndarray:
    """Dense (out_size, in_size) bilinear or bicubic matrix with torch's
    semantics (the JAX package's ``_resize_matrix``): bicubic is cubic
    convolution with a = -0.75 and clamped borders."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == out_size:
        np.fill_diagonal(m, 1.0)
        return m
    if align_corners:
        scale = (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        src = np.arange(out_size) * scale
    else:
        scale = in_size / out_size
        src = (np.arange(out_size) + 0.5) * scale - 0.5
    x0 = np.floor(src).astype(np.int64)
    if mode == "bilinear":
        dx = src - x0
        for off, w in ((0, 1.0 - dx), (1, dx)):
            np.add.at(m, (np.arange(out_size), np.clip(x0 + off, 0, in_size - 1)), w)
        return m
    if mode == "bicubic":
        a = -0.75

        def cubic(t):
            t = np.abs(t)
            return np.where(t <= 1.0, ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0,
                            np.where(t < 2.0, (((t - 5.0) * t + 8.0) * t - 4.0) * a, 0.0))

        for off in (-1, 0, 1, 2):
            np.add.at(m, (np.arange(out_size), np.clip(x0 + off, 0, in_size - 1)),
                      cubic(src - (x0 + off)))
        return m
    raise ValueError(f"unsupported mode: {mode}")


@functools.lru_cache(maxsize=64)
def _matrix_on(in_size: int, out_size: int, mode: str, align_corners: bool,
               device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(_resize_matrix(in_size, out_size, mode, align_corners)).to(
        device, dtype)


def _apply_separable(x: torch.Tensor, size: Tuple[int, int], mode: str,
                     align_corners: bool) -> torch.Tensor:
    """The H pass ``mh @ x``, then the W pass as one product over the rows;
    each pass rounds to x's dtype."""
    (h, w), (oh, ow) = x.shape[-2:], size
    mh = _matrix_on(h, oh, mode, align_corners, x.device, x.dtype)
    mw = _matrix_on(w, ow, mode, align_corners, x.device, x.dtype)
    with torch.autocast(device_type=x.device.type, enabled=False):
        y = torch.matmul(mh, x)
        return (y.reshape(-1, w) @ mw.t()).reshape(*x.shape[:-2], oh, ow)


def nearest_resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """torch legacy 'nearest': src = floor(dst * in / out)."""
    with torch.autocast(device_type=x.device.type, enabled=False):
        return F.interpolate(x, size=tuple(size), mode="nearest")


def bilinear_resize(x: torch.Tensor, size: Tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    if tuple(size) == tuple(x.shape[-2:]):
        return x
    return _apply_separable(x, size, "bilinear", align_corners)


def bicubic_resize(x: torch.Tensor, size: Tuple[int, int],
                   align_corners: bool = False) -> torch.Tensor:
    """Cubic convolution with a = -0.75, borders clamped (torch's bicubic)."""
    if tuple(size) == tuple(x.shape[-2:]):
        return x
    return _apply_separable(x, size, "bicubic", align_corners)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """out[n, c, h*r+i, w*r+j] = in[n, c*r*r + i*r + j, h, w]."""
    return F.pixel_shuffle(x, r)
