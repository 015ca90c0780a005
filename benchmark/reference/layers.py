"""Small shared layers: counterparts of ``ocpg_tpu/models/layers.py``.

Module and attribute names follow the JAX parameter tree (``layers_0``,
``fc``, ``q_proj`` ...), so ``utils/weights.py`` maps a flax tree onto them
by name.  Feature maps are NCHW here.

Numerics: the model runs under ``torch.autocast`` when its compute dtype is
bfloat16.  Where the JAX module pins float32, the port opens a float32
island with ``float32_island`` and casts its inputs with ``.float()``.

Dropout (``Dropout``) and stochastic depth (``DropPath``) are active when
the module is in training mode and draw their masks from the
``torch.Generator`` that the train step hands to the model
(``set_dropout_generator``); in eval mode they are the identity, as JAX's
``deterministic=True``.  JAX's dropout bits cannot be reproduced, so the
parity tests run with both off.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


# Set by the reference's train step while it runs a batch in blocks of rows:
# (clips in the whole batch, first clip of the block, clips in the block).
# Dropout and stochastic depth then draw the whole batch's mask, as the
# program draws it in one call, and keep the block's rows (the leading
# dimension of every tensor they see is clip-major).
BLOCK: Optional[tuple] = None


def _rows(shape, device, generator) -> torch.Tensor:
    """Uniform draws for a tensor of ``shape``: the block's rows of the whole
    batch's draw while ``BLOCK`` is set."""
    if BLOCK is None:
        return torch.rand(shape, generator=generator, device=device)
    total, start, count = BLOCK
    per = shape[0] // count
    full = torch.rand((per * total, *shape[1:]), generator=generator, device=device)
    return full[per * start: per * (start + count)]


def float32_island(x: torch.Tensor):
    """Context in which autocast is off, for float32 computations."""
    return torch.autocast(device_type=x.device.type, enabled=False)


class Dropout(nn.Module):
    """Inverted dropout at rate ``p``: kept elements are scaled by
    ``1 / (1 - p)``.  ``generator`` (a ``torch.Generator`` on the input's
    device) is set by the train step; without one it draws from PyTorch's
    default generator."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = _rows(x.shape, x.device, self.generator) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros((), dtype=x.dtype,
                                                                  device=x.device))


class DropPath(nn.Module):
    """Stochastic depth at rate ``p``: one Bernoulli keep draw per sample,
    shape ``(B, 1, 1, 1, 1)``, the kept branches scaled by ``1 / (1 - p)``
    (the JAX Swin block's ``drop_path``).  ``draw`` and the application are
    apart so that a caller can draw before a recomputed region and hand the
    same mask to the forward and to its recompute."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)
        self.generator: Optional[torch.Generator] = None

    def draw(self, batch: int, device: torch.device) -> Optional[torch.Tensor]:
        """The (B, 1, 1, 1, 1) keep mask, or None where the module is the identity."""
        if not self.training or self.p == 0.0:
            return None
        return _rows((batch, 1, 1, 1, 1), device, self.generator) < 1.0 - self.p

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor]) -> torch.Tensor:
        if keep is None:
            return x
        return x * keep.to(x.dtype) / (1.0 - self.p)


def set_dropout_generator(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Make every ``Dropout`` and ``DropPath`` under ``module`` draw from ``generator``."""
    for mod in module.modules():
        if isinstance(mod, (Dropout, DropPath)):
            mod.generator = generator


class MLP(nn.Module):
    """ReLU MLP with a linear last layer."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        for i in range(num_layers):
            setattr(self, f"layers_{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x


class FeatureResizer(nn.Module):
    """Linear + LayerNorm(eps=1e-12) + dropout."""

    def __init__(self, in_dim: int, output_dim: int, dropout: float = 0.1):
        super().__init__()
        self.fc = nn.Linear(in_dim, output_dim)
        self.layer_norm = nn.LayerNorm(output_dim, eps=1e-12)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(self.layer_norm(self.fc(x)))


class FrozenBatchNorm(nn.Module):
    """BatchNorm with frozen statistics and affine terms, held as buffers
    (the JAX package's ``frozen`` collection); eps 1e-5 before the rsqrt."""

    def __init__(self, features: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # NCHW
        scale = self.weight * torch.rsqrt(self.running_var + 1e-5)
        shift = self.bias - self.running_mean * scale
        return (x * scale.to(x.dtype)[:, None, None]
                + shift.to(x.dtype)[:, None, None])


class MultiheadAttention(nn.Module):
    """Multi-head attention on (B, L, C) with separate q/k/v projections,
    float32 logits and softmax, a key-padding mask (True = pad) that sets
    logits to float32's minimum, and dropout on the attention probabilities."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = Dropout(dropout)
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, lq, c = query.shape
        h = self.num_heads
        dh = c // h

        def split(x):
            return x.reshape(b, x.shape[1], h, dh).transpose(1, 2)   # (B, H, L, Dh)

        q = split(self.q_proj(query))
        k = split(self.k_proj(key))
        v = split(self.v_proj(value))
        logits = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(dh)
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, :],
                                        torch.finfo(torch.float32).min)
        attn = self.dropout(torch.softmax(logits, dim=-1).to(v.dtype))
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, lq, c)
        return self.out_proj(out)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))
