"""Sine positional encodings: counterparts of
``ocpg_tpu/models/position_encoding.py``.  Masks are bool, True = padding;
outputs are channels-last, as in the JAX package."""

from __future__ import annotations

import math

import torch


def _dim_t(num_pos_feats: int, temperature: float, device) -> torch.Tensor:
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    return temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_pos_feats)


def _interleave_sin_cos(pos: torch.Tensor) -> torch.Tensor:
    return torch.stack((pos[..., 0::2].sin(), pos[..., 1::2].cos()), -1).flatten(-2)


def position_embedding_sine_1d(mask: torch.Tensor, num_pos_feats: int = 256,
                               temperature: float = 10000.0, normalize: bool = True,
                               scale: float = 2 * math.pi) -> torch.Tensor:
    """(B, L) mask -> (B, L, C).  No -0.5 shift in the 1D variant."""
    not_mask = (~mask).float()
    x_embed = not_mask.cumsum(1)
    if normalize:
        x_embed = x_embed / (x_embed[:, -1:] + 1e-6) * scale
    return _interleave_sin_cos(x_embed[:, :, None]
                               / _dim_t(num_pos_feats, temperature, mask.device))


def position_embedding_sine_2d(mask: torch.Tensor, num_pos_feats: int = 128,
                               temperature: float = 10000.0, normalize: bool = True,
                               scale: float = 2 * math.pi) -> torch.Tensor:
    """(B, H, W) mask -> (B, H, W, 2 * num_pos_feats), channels (y, x),
    with the -0.5 half-pixel shift before normalising."""
    not_mask = (~mask).float()
    y_embed = not_mask.cumsum(1)
    x_embed = not_mask.cumsum(2)
    if normalize:
        y_embed = (y_embed - 0.5) / (y_embed[:, -1:, :] + 1e-6) * scale
        x_embed = (x_embed - 0.5) / (x_embed[:, :, -1:] + 1e-6) * scale
    dim_t = _dim_t(num_pos_feats, temperature, mask.device)
    pos_x = _interleave_sin_cos(x_embed[..., None] / dim_t)
    pos_y = _interleave_sin_cos(y_embed[..., None] / dim_t)
    return torch.cat((pos_y, pos_x), -1)
