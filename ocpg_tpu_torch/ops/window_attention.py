"""Swin (shifted-)window attention, with its gradient.

Counterpart of ``ocpg_tpu/ops/window_attention_pallas.py``.

* ``window_attention`` is the dispatcher.  A CUDA tensor goes through a
  ``torch.autograd.Function`` whose forward launches the hand-written kernel
  ``csrc/window_attention_fwd.cu`` (the Hopper port of the Pallas kernel
  ``window_attention_fused``), or raises, and whose backward recomputes
  through autograd of the plain version, as the JAX package's custom VJP
  (``_wattn_bwd``) recomputes through XLA; the mask gets no gradient.  A CPU
  tensor takes the plain version.  There is no probe and no fallback.
* ``window_attention_reference`` is the plain PyTorch version, the JAX
  module's ``window_attention_xla``: logits summed in float32 and stored in
  the input's type, plus the bias and the per-window mask in that type,
  softmax in float32, then ``@ v`` with float32 sums.
* ``window_attention_grad_reference`` is the backward rule alone.
* ``launches`` counts the kernel's launches, and nothing else.
* ``wattn_work`` gives one call's bytes and FLOPs (the card checks'
  bound), ``wattn_fwd_flops`` its FLOPs from the shapes; every forward
  through the dispatcher adds ``("wattn_fwd", wattn_fwd_flops(...))`` to an
  open ``ms_deform_attn.count_msda_flops`` context and hides its own work
  from ``FlopCounterMode`` (``dense_count_paused``).  The backward is plain
  PyTorch on every device, which that mode counts: on the card it
  recomputes the forward's two products, so there a step's dense count
  holds four products per call where the CPU's autograd holds two.

Shapes: q (pre-scaled by ``dh ** -0.5``), k, v ``(bw, n, heads, dh)``;
bias ``(heads, n, n)``; mask ``(nW, n, n)`` or None, applied to window
``b`` as ``mask[b % nW]`` (the window index varies fastest within bw).
Output ``(bw, n, heads, dh)`` in q's type.  The kernel takes n <= 392 (the
largest window, 8 x 7 x 7) and dh <= 64 (every Swin has dh = 32), float32
or bfloat16, and q, k, v whose (heads, dh) part is packed; k and v may be
the slices of the qkv projection's ``(bw, n, 3, heads, dh)`` output.  Its
bfloat16 body (tensor cores, 16-byte loads) also takes dh a multiple of 8
and q, k, v 16-byte aligned with strides that are multiples of 8 elements;
its float32 body computes in exact float32.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from . import _build
from .ms_deform_attn import _record_msda_flops, dense_count_paused

SOURCE = "window_attention_fwd.cu"
MAX_N = 392             # WATTN_MAX_N in csrc/window_attention_fwd.cu
MAX_HEAD_DIM = 64       # WATTN_MAX_DH
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (set it to 0 to reset)
launches = 0


def window_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               bias: torch.Tensor,
                               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: ``window_attention_xla`` with q's type as the compute type."""
    bw, n, h, _ = q.shape
    dtype = q.dtype
    with torch.autocast(device_type=q.device.type, enabled=False):
        attn = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()).to(dtype)
        attn = attn + bias[None].to(dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(bw // nw, nw, h, n, n)
                    + mask.to(dtype)[None, :, None]).reshape(bw, h, n, n)
        attn = torch.softmax(attn.float(), dim=-1).to(dtype)
        return torch.einsum("bhnm,bmhd->bnhd", attn.float(), v.float()).to(dtype)


def window_attention_grad_reference(q, k, v, bias, mask, grad_out):
    """(d_q, d_k, d_v, d_bias) for the cotangent ``grad_out``: autograd
    through ``window_attention_reference`` (the mask gets none)."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (q, k, v, bias)]
        out = window_attention_reference(*inputs, mask)
        return torch.autograd.grad(out, inputs, grad_out.to(out.dtype))


def _check(q, k, v, bias, mask):
    if q.dim() != 4:
        raise ValueError(f"q must be (bw, n, heads, dh), got {tuple(q.shape)}")
    bw, n, h, _ = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != q {tuple(q.shape)}")
    if bias.shape != (h, n, n):
        raise ValueError(f"bias {tuple(bias.shape)} != {(h, n, n)}")
    if mask is not None and (mask.dim() != 3 or mask.shape[1:] != (n, n)
                             or bw % mask.shape[0] != 0):
        raise ValueError(f"mask {tuple(mask.shape)} must be (nW, {n}, {n}) with "
                         f"nW dividing bw={bw}")


def _kernel():
    fn = _build.load(SOURCE).wattn_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 6 + [ctypes.c_int, ctypes.c_void_p])
    return fn


def _launch(q, k, v, bias, mask):
    global launches
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"window-attention kernel takes float32 or bfloat16, got {q.dtype}")
    bw, n, h, dh = q.shape
    if n > MAX_N or dh > MAX_HEAD_DIM:
        raise ValueError(f"window-attention kernel takes n <= {MAX_N} and dh <= "
                         f"{MAX_HEAD_DIM}, got n={n}, dh={dh}")
    if q.dtype == torch.bfloat16:
        if dh % 8:
            raise ValueError(f"the bfloat16 window-attention kernel takes dh a multiple "
                             f"of 8, got {dh}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or t.stride(0) % 8 or t.stride(1) % 8:
                raise ValueError(f"the bfloat16 window-attention kernel takes 16-byte "
                                 f"aligned rows: {name} at {t.data_ptr():#x}, strides "
                                 f"{t.stride()}")
    named = [("q", q), ("k", k), ("v", v), ("bias", bias)]
    if mask is not None:
        named.append(("mask", mask))
    for name, t in named:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype}, got {t.dtype}")
    for name, t in named[:3]:
        if t.stride(3) != 1 or t.stride(2) != dh:
            raise ValueError(f"{name} must have its (heads, dh) part packed, strides "
                             f"{t.stride()}")
    for name, t in named[3:]:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((bw, n, h, dh), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                        None if mask is None else mask.data_ptr(), out.data_ptr(),
                        bw, n, h, dh, 1 if mask is None else mask.shape[0],
                        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                        v.stride(0), v.stride(1), _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"wattn_fwd launch failed: cudaError {err}")
    launches += 1
    return out


class _WindowAttentionFunction(torch.autograd.Function):
    """K7 forward, plain-recompute backward."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask):
        ctx.save_for_backward(q, k, v, bias, mask)
        return _launch(q, k, v, bias, mask)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        q, k, v, bias, mask = ctx.saved_tensors
        return (*window_attention_grad_reference(q, k, v, bias, mask, grad_out), None)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Window attention; CUDA tensors run the kernel, CPU tensors the plain version."""
    _check(q, k, v, bias, mask)
    with dense_count_paused():
        if q.is_cuda:
            # bias and mask in q's type, as the plain version adds them
            out = _WindowAttentionFunction.apply(
                q, k, v, bias.to(q.dtype).contiguous(),
                None if mask is None else mask.to(q.dtype).contiguous())
        elif q.device.type == "cpu":
            out = window_attention_reference(q, k, v, bias, mask)
        else:
            raise ValueError(f"window attention has no path for device {q.device}")
    _record_msda_flops("wattn_fwd", wattn_fwd_flops(*q.shape))
    return out


def wattn_fwd_flops(bw: int, n: int, heads: int, dh: int) -> float:
    """FLOPs of one forward from its shapes: the two products q.k^T and
    P.v, 2 flops per multiply-add (softmax, bias and mask not counted)."""
    return float(4 * bw * heads * n * n * dh)


def wattn_work(q: torch.Tensor, mask: Optional[torch.Tensor]):
    """(bytes, flops, L2 bytes) of one call: q, k, v, bias and the mask
    read once in the input's type, the output written once; the two
    products (``wattn_fwd_flops``); and the bytes of bias and mask that the
    kernel reads from L2 (every (window, head) reads its n x n of each: the
    bias once per window, the mask once per head)."""
    bw, n, h, dh = q.shape
    es = q.element_size()
    nbytes = 4 * q.numel() * es + h * n * n * es
    if mask is not None:
        nbytes += mask.numel() * es
    l2_bytes = bw * h * n * n * es * (1 if mask is None else 2)
    return nbytes, int(wattn_fwd_flops(bw, n, h, dh)), l2_bytes
