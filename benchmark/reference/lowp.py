"""The control: the reference computed one precision below the one the
configuration states.  The configurations compute in bfloat16, so the
control runs the reference as the configuration states it (bfloat16 under
autocast, with its float32 islands) and rounds both operands of every
matrix product and convolution, forward and backward, to float8 (e4m3)
with one scale per tensor (its largest magnitude at 448, e4m3's largest
finite value), as float8 training and serving do.

    with Float8Operands():
        ...   # the reference's forward, or its train step
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

# op -> the positions of its two matrix (or input and weight) operands
_OPERANDS = {
    aten.mm.default: (0, 1),
    aten.bmm.default: (0, 1),
    aten.addmm.default: (1, 2),
    aten.baddbmm.default: (1, 2),
    aten.convolution.default: (0, 1),
    aten.convolution_backward.default: (0, 1, 2),
}

E4M3_MAX = 448.0


def to_float8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 under one per-tensor scale, in its own type."""
    if not t.is_floating_point() or t.numel() == 0:
        return t
    scale = E4M3_MAX / t.detach().abs().amax().float().clamp(min=1e-30)
    return ((t.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(t.dtype)


class Float8Operands(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        idx = _OPERANDS.get(func)
        if idx is not None:
            args = list(args)
            for i in idx:
                args[i] = to_float8(args[i])
        return func(*args, **(kwargs or {}))
