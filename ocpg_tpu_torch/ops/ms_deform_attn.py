"""Multi-scale deformable attention (MSDA), channel-major layout, with its
gradient.

Counterpart of ``ocpg_tpu/ops/ms_deform_attn.py::ms_deform_attn_fast_cm``
and its custom VJP.

* ``ms_deform_attn_cm`` is the dispatcher.  A CUDA tensor goes through a
  ``torch.autograd.Function`` whose forward launches the hand-written kernel
  ``csrc/ms_deform_attn_fwd.cu`` (the Hopper port of the Pallas kernel
  ``ms_deform_attn_pallas_cm``) and whose backward launches
  ``csrc/ms_deform_attn_bwd.cu`` (the port of ``ms_deform_attn_pallas_bwd_cm``),
  or raises; a CPU tensor takes the plain version, which autograd
  differentiates.  There is no probe and no fallback.
* ``ms_deform_attn_cm_reference`` is the plain PyTorch version: per level,
  the four bilinear corners gathered at ``x * W - 0.5``, ``y * H - 0.5``
  (zero padding, ``align_corners=False``), then the attention-weighted sum.
  Its autograd gives the right-sided derivative at exactly integer
  coordinates (``floor`` has no gradient), as the JAX gather path does.
* ``ms_deform_attn_cm_backward`` is the backward alone: K2 on CUDA tensors,
  the plain version's autograd on CPU tensors.
* ``launches`` and ``bwd_launches`` count the two kernels' launches, and
  nothing else.

Shapes: value ``(N, S, M, D)`` with ``S = sum_l H_l * W_l``; x, y and aw
``(N, M, L, P, Lq)`` (normalised [0, 1] coordinates and attention weights);
output ``(N, Lq, M * D)`` in the value's dtype.  Sampling math and
accumulation are float32.  A non-finite coordinate (a wholly padded frame
has valid ratio 0) samples nothing and gets zero gradients.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import _build

Shapes = Sequence[Tuple[int, int]]

SOURCE = "ms_deform_attn_fwd.cu"
BWD_SOURCE = "ms_deform_attn_bwd.cu"
MAX_LEVELS = 8          # MSDA_MAX_LEVELS in csrc/msda_common.cuh
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (set them to 0 to reset)
launches = 0
bwd_launches = 0


def ms_deform_attn_cm_reference(value: torch.Tensor, spatial_shapes: Shapes,
                                x_cm: torch.Tensor, y_cm: torch.Tensor,
                                aw_cm: torch.Tensor) -> torch.Tensor:
    """Plain version: four corner gathers per level, f32 sampling and sum
    (float64 inputs compute in float64, for gradcheck)."""
    n, s, m, d = value.shape
    _, _, nl, p, lq = x_cm.shape
    ct = torch.promote_types(value.dtype, torch.float32)
    v = value.to(ct).permute(0, 2, 1, 3).reshape(n * m, s, d)
    out = torch.zeros(n * m, p * lq, d, dtype=ct, device=value.device)
    start = 0
    for lid, (h, w) in enumerate(spatial_shapes):
        vl = v[:, start:start + h * w]
        x = x_cm[:, :, lid].to(ct).reshape(n * m, p * lq)
        y = y_cm[:, :, lid].to(ct).reshape(n * m, p * lq)
        finite = torch.isfinite(x) & torch.isfinite(y)
        # a non-finite sample is moved wholly outside the map: no value, no gradient
        xp = torch.where(finite, x, -2.0) * w - 0.5
        yp = torch.where(finite, y, -2.0) * h - 0.5
        a = aw_cm[:, :, lid].to(ct).reshape(n * m, p * lq).masked_fill(~finite, 0.0)
        x0, y0 = torch.floor(xp), torch.floor(yp)
        dx, dy = xp - x0, yp - y0
        for cx, cy, cw in ((x0, y0, (1 - dx) * (1 - dy)), (x0 + 1, y0, dx * (1 - dy)),
                           (x0, y0 + 1, (1 - dx) * dy), (x0 + 1, y0 + 1, dx * dy)):
            inside = (cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1)
            idx = (cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)).long()
            rows = torch.gather(vl, 1, idx[..., None].expand(-1, -1, d))
            out = out + (torch.where(inside, cw, 0.0) * a)[..., None] * rows
        start += h * w
    out = out.reshape(n * m, p, lq, d).sum(1)
    return (out.reshape(n, m, lq, d).permute(0, 2, 1, 3).reshape(n, lq, m * d)
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


def _kernel(source: str, symbol: str, n_pointers: int):
    """A C entry point of a kernel library (built on first use): pointers,
    the level heights and widths, 8 ints, the stream."""
    fn = getattr(_build.load(source), symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.POINTER(ctypes.c_int)] * 2
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    return fn


def _check_cuda(value, named):
    if value.dtype not in _DTYPE_CODE:
        raise TypeError(f"MSDA kernel takes float32 or bfloat16 value, got {value.dtype}")
    for name, t, dtype in named:
        if not t.is_cuda or t.device != value.device:
            raise ValueError(f"{name} is on {t.device}, value on {value.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")


def _call(fn, name, value, spatial_shapes, x_cm, pointers):
    n, s, m, d = value.shape
    _, _, nl, p, lq = x_cm.shape
    hs = (ctypes.c_int * nl)(*[int(h) for h, _ in spatial_shapes])
    ws = (ctypes.c_int * nl)(*[int(w) for _, w in spatial_shapes])
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        err = fn(*[t.data_ptr() for t in pointers], hs, ws, n, s, m, d, nl, p, lq,
                 _DTYPE_CODE[value.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _launch(value, spatial_shapes, x_cm, y_cm, aw_cm):
    global launches
    f32 = torch.float32
    _check_cuda(value, (("value", value, value.dtype), ("x_cm", x_cm, f32),
                        ("y_cm", y_cm, f32), ("aw_cm", aw_cm, f32)))
    n, _, m, d = value.shape
    out = torch.empty((n, x_cm.shape[-1], m * d), dtype=value.dtype, device=value.device)
    _call(_kernel(SOURCE, "msda_cm_fwd", 5), "msda_cm_fwd", value, spatial_shapes, x_cm,
          (value, x_cm, y_cm, aw_cm, out))
    launches += 1
    return out


def _launch_bwd(value, spatial_shapes, x_cm, y_cm, aw_cm, grad_out):
    global bwd_launches
    f32 = torch.float32
    _check_cuda(value, (("value", value, value.dtype), ("x_cm", x_cm, f32),
                        ("y_cm", y_cm, f32), ("aw_cm", aw_cm, f32),
                        ("grad_out", grad_out, value.dtype)))
    n, _, m, d = value.shape
    if grad_out.shape != (n, x_cm.shape[-1], m * d):
        raise ValueError(f"grad_out {tuple(grad_out.shape)} != output "
                         f"{(n, x_cm.shape[-1], m * d)}")
    # d_value is summed with float32 atomics into zeroed scratch; the
    # coordinate and weight gradients are written once per sample
    d_value = torch.zeros(value.shape, dtype=f32, device=value.device)
    d_x, d_y, d_aw = (torch.empty_like(x_cm) for _ in range(3))
    _call(_kernel(BWD_SOURCE, "msda_cm_bwd", 9), "msda_cm_bwd", value, spatial_shapes,
          x_cm, (value, x_cm, y_cm, aw_cm, grad_out, d_value, d_x, d_y, d_aw))
    bwd_launches += 1
    return d_value.to(value.dtype), d_x, d_y, d_aw


def ms_deform_attn_cm_backward(value: torch.Tensor, spatial_shapes: Shapes,
                               x_cm: torch.Tensor, y_cm: torch.Tensor,
                               aw_cm: torch.Tensor, grad_out: torch.Tensor):
    """(d_value, d_x, d_y, d_aw) for the cotangent ``grad_out``: K2 on CUDA
    tensors, autograd through the plain version on CPU tensors."""
    _check(value, spatial_shapes, x_cm, y_cm, aw_cm)
    if value.is_cuda:
        return _launch_bwd(value, spatial_shapes, x_cm, y_cm, aw_cm,
                           grad_out.to(value.dtype).contiguous())
    if value.device.type == "cpu":
        return ms_deform_attn_cm_grad_reference(value, spatial_shapes, x_cm, y_cm, aw_cm,
                                                grad_out)
    raise ValueError(f"MSDA has no path for device {value.device}")


def ms_deform_attn_cm_grad_reference(value, spatial_shapes, x_cm, y_cm, aw_cm, grad_out):
    """Plain backward: autograd through ``ms_deform_attn_cm_reference``."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (value, x_cm, y_cm, aw_cm)]
        out = ms_deform_attn_cm_reference(inputs[0], spatial_shapes, *inputs[1:])
        return torch.autograd.grad(out, inputs, grad_out.to(out.dtype))


class _MSDAFunction(torch.autograd.Function):
    """K1 forward, K2 backward."""

    @staticmethod
    def forward(ctx, value, x_cm, y_cm, aw_cm, spatial_shapes):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, x_cm, y_cm, aw_cm)
        return _launch(value, spatial_shapes, x_cm, y_cm, aw_cm)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        value, x_cm, y_cm, aw_cm = ctx.saved_tensors
        grads = ms_deform_attn_cm_backward(value, ctx.spatial_shapes, x_cm, y_cm, aw_cm,
                                           grad_out)
        return (*grads, None)


def ms_deform_attn_cm(value: torch.Tensor, spatial_shapes: Shapes,
                      x_cm: torch.Tensor, y_cm: torch.Tensor,
                      aw_cm: torch.Tensor) -> torch.Tensor:
    """MSDA forward; CUDA tensors run the kernels, CPU tensors the plain version."""
    _check(value, spatial_shapes, x_cm, y_cm, aw_cm)
    if value.is_cuda:
        return _MSDAFunction.apply(value, x_cm, y_cm, aw_cm, tuple(spatial_shapes))
    if value.device.type == "cpu":
        return ms_deform_attn_cm_reference(value, spatial_shapes, x_cm, y_cm, aw_cm)
    raise ValueError(f"MSDA has no path for device {value.device}")
