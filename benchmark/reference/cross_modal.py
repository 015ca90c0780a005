"""Spectrum-guided cross-modal fusion: counterparts of
``ocpg_tpu/models/cross_modal.py`` (LFM spectral filter, VL fusion).

``LFM`` runs in float32 whatever the compute dtype (an FFT island), on NCHW
maps, and returns its output in the input's dtype with the Gaussian it used.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .image import bilinear_resize
from .layers import MultiheadAttention, float32_island


def make_gaussian(height: int, width: int, sigma: float, device) -> torch.Tensor:
    """Gaussian centred at (h//2, w//2) in unshifted FFT coordinates, (1, 1, H, W)."""
    yv = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    xv = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    g = torch.exp(-((yv - height // 2) ** 2 + (xv - width // 2) ** 2) / (2.0 * sigma ** 2))
    return g[None, None]


class LFM(nn.Module):
    """Learned frequency-domain modulation (LFMResizeAdaptive)."""

    def __init__(self, num_channels: int, sigma: float = 7.0):
        super().__init__()
        c = num_channels
        self.sigma = sigma
        self.laplace = nn.Conv2d(c, c, 3)
        self.fc1 = nn.Linear(c, c, bias=False)
        self.fc2 = nn.Linear(c, 1, bias=False)
        self.conv1 = nn.Conv2d(2 * c, 2 * c, 1)
        self.conv2 = nn.Conv2d(2 * c, 2 * c, 1)

    def forward(self, x: torch.Tensor,
                gauss_map: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        in_dtype = x.dtype
        with float32_island(x):
            x = x.float()
            b, c, h, w = x.shape
            # 3x3 VALID conv; SAME on maps smaller than the kernel, so the
            # mean below is over a non-empty map
            pad = 0 if (h >= 3 and w >= 3) else 1
            coef = F.conv2d(x, self.laplace.weight, self.laplace.bias, padding=pad)
            coef = coef.mean(dim=(2, 3))
            coef = torch.sigmoid(self.fc2(F.relu(self.fc1(coef))))[:, :, None, None]

            y = torch.fft.fft2(x)
            if gauss_map is None:
                high_filter = make_gaussian(h, w, self.sigma, x.device)
            else:
                high_filter = bilinear_resize(gauss_map, (h, w), align_corners=False)
            y = y * (1.0 - coef * high_filter)

            y_f = torch.cat([y.real, y.imag], 1)
            y_f = self.conv2(F.relu(self.conv1(y_f)))
            y_real, y_imag = torch.chunk(y_f, 2, 1)
            y = torch.fft.ifft2(torch.complex(y_real, y_imag)).real
            return (x + y).to(in_dtype), high_filter


class VisionLanguageFusion(nn.Module):
    """Cross-attention vision <- text with multiplicative gating."""

    def __init__(self, dim: int, num_heads: int = 8, dropout: float = 0.0):
        super().__init__()
        self.multihead_attn = MultiheadAttention(dim, num_heads, dropout)

    def forward(self, visual: torch.Tensor, text: torch.Tensor,
                text_pad_mask: torch.Tensor, text_pos: torch.Tensor) -> torch.Tensor:
        attn_out = self.multihead_attn(visual, text + text_pos, text,
                                       key_padding_mask=text_pad_mask)
        return visual * attn_out
