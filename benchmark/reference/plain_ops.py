"""The plain operations the reference model runs where the program launches
its kernels, and the few names the copied modules import from elsewhere.

* ``ms_deform_attn_cm``: multi-scale deformable attention as four bilinear
  corner gathers per level at ``x * W - 0.5``, ``y * H - 0.5`` (zero
  padding), weighted and summed; a non-finite sample reads nothing.
  Every call is also reported to ``MSDA_CALLS`` while it is a list, so a
  FLOP count can add the work that ``FlopCounterMode`` cannot see in a
  gather.
* ``window_attention``: Swin window attention, logits and softmax in
  float32 (the reference runs everything in float32).
* ``IMAGENET_MEAN`` / ``IMAGENET_STD`` and ``all_reduce_`` (the identity:
  the reference runs on one device).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

Shapes = Sequence[Tuple[int, int]]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# (spatial_shapes, n, m, d, p, lq, requires_grad) of every MSDA call while a list
MSDA_CALLS: Optional[List[tuple]] = None


def all_reduce_(mesh, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    if mesh is not None:
        raise ValueError("the reference runs on one device")
    return t


def ms_deform_attn_cm(value: torch.Tensor, spatial_shapes: Shapes, x_cm: torch.Tensor,
                      y_cm: torch.Tensor, aw_cm: torch.Tensor) -> torch.Tensor:
    """value (N, S, M, D); x, y, aw (N, M, L, P, Lq) -> (N, Lq, M * D)."""
    n, s, m, d = value.shape
    _, _, nl, p, lq = x_cm.shape
    if MSDA_CALLS is not None:
        MSDA_CALLS.append((tuple(map(tuple, spatial_shapes)), n, m, d, p, lq,
                           torch.is_grad_enabled() and value.requires_grad))
    ct = torch.promote_types(value.dtype, torch.float32)
    v = value.to(ct).permute(0, 2, 1, 3).reshape(n * m, s, d)
    out = torch.zeros(n * m, p * lq, d, dtype=ct, device=value.device)
    start = 0
    for lid, (h, w) in enumerate(spatial_shapes):
        vl = v[:, start:start + h * w]
        x = x_cm[:, :, lid].to(ct).reshape(n * m, p * lq)
        y = y_cm[:, :, lid].to(ct).reshape(n * m, p * lq)
        finite = torch.isfinite(x) & torch.isfinite(y)
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


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (pre-scaled), k, v (bw, n, heads, dh); bias (heads, n, n); mask
    (nW, n, n) applied to window b as mask[b % nW]."""
    bw, n, h, _ = q.shape
    dtype = q.dtype
    attn = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()).to(dtype)
    attn = attn + bias[None].to(dtype)
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.reshape(bw // nw, nw, h, n, n)
                + mask.to(dtype)[None, :, None]).reshape(bw, h, n, n)
    attn = torch.softmax(attn.float(), dim=-1).to(dtype)
    return torch.einsum("bhnm,bmhd->bnhd", attn.float(), v.float()).to(dtype)
