"""Multi-scale deformable attention (MSDA) forward, channel-major layout.

Counterpart of ``ocpg_tpu/ops/ms_deform_attn.py::ms_deform_attn_fast_cm``
(forward only; the backward kernel comes with the train slice).

* ``ms_deform_attn_cm`` is the dispatcher.  A CUDA tensor launches the
  hand-written kernel ``csrc/ms_deform_attn_fwd.cu`` (the Hopper port of the
  Pallas kernel ``ms_deform_attn_pallas_cm``) or raises; a CPU tensor takes
  the plain version.  There is no probe and no fallback.
* ``ms_deform_attn_cm_reference`` is the plain PyTorch version: per-level
  ``F.grid_sample`` (bilinear, zero padding, ``align_corners=False``) on
  ``2 * loc - 1``, then the attention-weighted sum.
* ``launches`` counts the kernel's launches, and nothing else.

Shapes: value ``(N, S, M, D)`` with ``S = sum_l H_l * W_l``; x, y and aw
``(N, M, L, P, Lq)`` (normalised [0, 1] coordinates and attention weights);
output ``(N, Lq, M * D)`` in the value's dtype.  Sampling math and
accumulation are float32.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build

Shapes = Sequence[Tuple[int, int]]

SOURCE = "ms_deform_attn_fwd.cu"
MAX_LEVELS = 8          # MSDA_MAX_LEVELS in the kernel source
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (set it to 0 to reset)
launches = 0


def ms_deform_attn_cm_reference(value: torch.Tensor, spatial_shapes: Shapes,
                                x_cm: torch.Tensor, y_cm: torch.Tensor,
                                aw_cm: torch.Tensor) -> torch.Tensor:
    """Plain version: grid_sample per level, f32 sampling and sum."""
    n, s, m, d = value.shape
    _, _, nl, p, lq = x_cm.shape
    v = value.float().permute(0, 2, 3, 1).reshape(n * m, d, s)
    out = torch.zeros(n * m, d, lq, dtype=torch.float32, device=value.device)
    start = 0
    for lid, (h, w) in enumerate(spatial_shapes):
        vl = v[:, :, start:start + h * w].reshape(n * m, d, h, w)
        # (N, M, P, Lq) -> (NM, Lq, P) grid of (x, y)
        gx = x_cm[:, :, lid].float().reshape(n * m, p, lq).transpose(1, 2)
        gy = y_cm[:, :, lid].float().reshape(n * m, p, lq).transpose(1, 2)
        # a non-finite coordinate (a wholly padded frame has valid ratio 0)
        # samples nothing, as in the kernel and the JAX gather path
        finite = torch.isfinite(gx) & torch.isfinite(gy)
        grid = torch.stack([gx, gy], -1).masked_fill(~finite[..., None], -1.0)
        g = F.grid_sample(vl, 2 * grid - 1, mode="bilinear", padding_mode="zeros",
                          align_corners=False)                 # (NM, D, Lq, P)
        a = aw_cm[:, :, lid].float().reshape(n * m, p, lq).transpose(1, 2)
        a = a.masked_fill(~finite, 0.0)[:, None]
        out = out + (g * a).sum(-1)
        start += h * w
    return (out.reshape(n, m, d, lq).permute(0, 3, 1, 2).reshape(n, lq, m * d)
            .to(value.dtype))


def _check(value, spatial_shapes, x_cm, y_cm, aw_cm):
    if value.dim() != 4:
        raise ValueError(f"value must be (N, S, M, D), got {tuple(value.shape)}")
    n, s, m, d = value.shape
    if x_cm.dim() != 5:
        raise ValueError(f"x_cm must be (N, M, L, P, Lq), got {tuple(x_cm.shape)}")
    nl = len(spatial_shapes)
    if not 1 <= nl <= MAX_LEVELS:
        raise ValueError(f"{nl} levels; the kernel takes 1..{MAX_LEVELS}")
    if s != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"S={s} != sum of level sizes {tuple(spatial_shapes)}")
    if x_cm.shape[:3] != (n, m, nl):
        raise ValueError(f"x_cm {tuple(x_cm.shape)} does not match value "
                         f"{tuple(value.shape)} and {nl} levels")
    for name, t in (("y_cm", y_cm), ("aw_cm", aw_cm)):
        if t.shape != x_cm.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != x_cm {tuple(x_cm.shape)}")


def _kernel():
    """The C entry point of the kernel library (built on first use)."""
    fn = _build.load(SOURCE).msda_cm_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_int)] * 2
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    return fn


def _launch(value, spatial_shapes, x_cm, y_cm, aw_cm):
    global launches
    if value.dtype not in _DTYPE_CODE:
        raise TypeError(f"MSDA kernel takes float32 or bfloat16 value, got {value.dtype}")
    for name, t in (("value", value), ("x_cm", x_cm), ("y_cm", y_cm), ("aw_cm", aw_cm)):
        if not t.is_cuda or t.device != value.device:
            raise ValueError(f"{name} is on {t.device}, value on {value.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "value" and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    n, s, m, d = value.shape
    _, _, nl, p, lq = x_cm.shape
    out = torch.empty((n, lq, m * d), dtype=value.dtype, device=value.device)
    fn = _kernel()
    hs = (ctypes.c_int * nl)(*[int(h) for h, _ in spatial_shapes])
    ws = (ctypes.c_int * nl)(*[int(w) for _, w in spatial_shapes])
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        err = fn(value.data_ptr(), x_cm.data_ptr(), y_cm.data_ptr(), aw_cm.data_ptr(),
                 out.data_ptr(), hs, ws, n, s, m, d, nl, p, lq,
                 _DTYPE_CODE[value.dtype], stream)
    if err != 0:
        raise RuntimeError(f"msda_cm_fwd launch failed: cudaError {err}")
    launches += 1
    return out


def ms_deform_attn_cm(value: torch.Tensor, spatial_shapes: Shapes,
                      x_cm: torch.Tensor, y_cm: torch.Tensor,
                      aw_cm: torch.Tensor) -> torch.Tensor:
    """MSDA forward; CUDA tensors run the kernel, CPU tensors the plain version."""
    _check(value, spatial_shapes, x_cm, y_cm, aw_cm)
    if value.is_cuda:
        return _launch(value, spatial_shapes, x_cm, y_cm, aw_cm)
    if value.device.type == "cpu":
        return ms_deform_attn_cm_reference(value, spatial_shapes, x_cm, y_cm, aw_cm)
    raise ValueError(f"MSDA has no path for device {value.device}")
