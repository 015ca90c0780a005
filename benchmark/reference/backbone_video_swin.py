"""Video Swin Transformer backbone: counterpart of
``ocpg_tpu/models/backbone_video_swin.py``.

A 3D shifted-window transformer with patch (1, 4, 4) (time is never
downsampled) and window (8, 7, 7); each stage's output is taken before its
downsampling, so the four levels have strides 4, 8, 16 and 32.  It takes
NCHW frames, works channels-last inside (``(B, T, H, W, C)``), and returns
the four levels as NCHW.  Modules are named after the JAX tree
(``stage{S}_block{I}``, ``downsample{S}``, ``patch_embed``, ``patch_norm``).

Numerics follow the JAX module's dtypes: LayerNorm has eps 1e-6 and returns
the compute dtype (flax ``LayerNorm(dtype=...)``), so under bfloat16 the
residual stream is bfloat16; GELU is the tanh approximation under bfloat16
and the exact erf under float32.  Window attention is
``ops/window_attention.py``: the hand-written kernel (K7) on the GPU, the
plain version on the CPU.

In training mode each block drops its two residual branches per sample
(stochastic depth, ``layers.DropPath``) at the rate ``linspace(0, 0.2,
sum(depths))[block]``.  ``use_checkpoint`` recomputes each
block in the backward (``torch.utils.checkpoint``, JAX's ``nn.remat``); the
block's two keep masks are drawn before it and handed to it, so the
recompute applies the masks the forward drew (checkpoint restores only the
default generators, not the train step's).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .plain_ops import window_attention
from .layers import DropPath

Window = Tuple[int, int, int]
MLP_RATIO = 4       # every Swin configuration's
DROP_PATH_RATE = 0.2    # the last block's stochastic-depth rate (the JAX default)


def _get_window_size(dims, window_size, shift_size):
    """Clamp the window to the input's dims; no shift where clamped."""
    ws, ss = list(window_size), list(shift_size)
    for i in range(3):
        if dims[i] <= window_size[i]:
            ws[i] = dims[i]
            ss[i] = 0
    return tuple(ws), tuple(ss)


@functools.lru_cache(maxsize=None)
def _sw_attn_mask(tp: int, hp: int, wp: int, ws: Window, ss: Window) -> Optional[np.ndarray]:
    """The SW-MSA attention mask (nW, N, N): 0 within a region, -100 across."""
    if not any(ss):
        return None
    img = np.zeros((tp, hp, wp), dtype=np.int32)
    cnt = 0
    for t in (slice(-ws[0]), slice(-ws[0], -ss[0]), slice(-ss[0], None)) if ss[0] else (slice(None),):
        for h in (slice(-ws[1]), slice(-ws[1], -ss[1]), slice(-ss[1], None)) if ss[1] else (slice(None),):
            for w in (slice(-ws[2]), slice(-ws[2], -ss[2]), slice(-ss[2], None)) if ss[2] else (slice(None),):
                img[t, h, w] = cnt
                cnt += 1
    img = img.reshape(tp // ws[0], ws[0], hp // ws[1], ws[1], wp // ws[2], ws[2])
    img = img.transpose(0, 2, 4, 1, 3, 5).reshape(-1, ws[0] * ws[1] * ws[2])
    diff = img[:, None, :] - img[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _relative_position_index(ws: Window) -> np.ndarray:
    """The (N, N) index into the relative-position-bias table."""
    wt, wh, ww = ws
    coords = np.stack(np.meshgrid(np.arange(wt), np.arange(wh), np.arange(ww),
                                  indexing="ij")).reshape(3, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wt - 1
    rel[:, :, 1] += wh - 1
    rel[:, :, 2] += ww - 1
    rel[:, :, 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[:, :, 1] *= 2 * ww - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=32)
def _mask_tensor(tp, hp, wp, ws, ss, device, dtype) -> torch.Tensor:
    """The SW-MSA mask on ``device`` in ``dtype``, built once per shape (its
    0 and -100 are exact in bfloat16)."""
    return torch.from_numpy(_sw_attn_mask(tp, hp, wp, ws, ss)).to(device, dtype)


@functools.lru_cache(maxsize=32)
def _index_tensor(full: Window, n: int, device) -> torch.Tensor:
    return torch.from_numpy(_relative_position_index(full)[:n, :n].reshape(-1)).to(device)


class LayerNorm(nn.LayerNorm):
    """flax ``LayerNorm``: eps 1e-6, float32 statistics, the input's dtype out."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


class WindowAttention3D(nn.Module):
    """W-MSA / SW-MSA with relative position bias.  The bias table is sized
    by the block's full window; a call with a smaller effective window (a
    short clip) takes the full window's index cut to ``[:n, :n]``."""

    def __init__(self, dim: int, num_heads: int, full_window: Window):
        super().__init__()
        self.num_heads = num_heads
        self.full_window = tuple(full_window)
        wt, wh, ww = self.full_window
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * wt - 1) * (2 * wh - 1) * (2 * ww - 1), num_heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        bw, n, c = x.shape                      # x: (windows, N, C)
        h = self.num_heads
        dh = c // h
        idx = _index_tensor(self.full_window, n, x.device)
        bias = self.relative_position_bias_table[idx].reshape(n, n, h).permute(2, 0, 1)
        # q, k, v stay slices of the projection's output (no head transpose)
        qkv = self.qkv(x).reshape(bw, n, 3, h, dh)
        q, k, v = qkv[:, :, 0] * dh ** -0.5, qkv[:, :, 1], qkv[:, :, 2]
        out = window_attention(q, k, v, bias, mask)
        return self.proj(out.reshape(bw, n, c))


class SwinBlock3D(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: Window = (8, 7, 7),
                 shift: bool = False, drop_path: float = 0.0):
        super().__init__()
        self.window_size = tuple(window_size)
        self.shift = shift
        self.drop_path = DropPath(drop_path)
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention3D(dim, num_heads, self.window_size)
        self.norm2 = LayerNorm(dim)
        self.mlp_fc1 = nn.Linear(dim, MLP_RATIO * dim)
        self.mlp_fc2 = nn.Linear(MLP_RATIO * dim, dim)

    def forward(self, x: torch.Tensor, keep_attn: Optional[torch.Tensor] = None,
                keep_mlp: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, T, H, W, C); keep_attn and keep_mlp are the two residual
        branches' stochastic-depth masks (``drop_path.draw``), None to keep both."""
        b, t, hh, ww_, c = x.shape
        shift = tuple(w // 2 for w in self.window_size) if self.shift else (0, 0, 0)
        ws, ss = _get_window_size((t, hh, ww_), self.window_size, shift)

        shortcut = x
        x = self.norm1(x)
        pad = [(ws[i] - (t, hh, ww_)[i] % ws[i]) % ws[i] for i in range(3)]
        x = F.pad(x, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
        tp, hp, wp = x.shape[1:4]
        mask = None
        if any(ss):
            x = torch.roll(x, shifts=(-ss[0], -ss[1], -ss[2]), dims=(1, 2, 3))
            mask = _mask_tensor(tp, hp, wp, ws, ss, x.device, x.dtype)

        # window partition: (B, T/wt, wt, H/wh, wh, W/ww, ww, C) -> (windows, N, C)
        xw = x.reshape(b, tp // ws[0], ws[0], hp // ws[1], ws[1], wp // ws[2], ws[2], c)
        xw = xw.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, ws[0] * ws[1] * ws[2], c)
        attn = self.attn(xw, mask)
        attn = attn.reshape(b, tp // ws[0], hp // ws[1], wp // ws[2], ws[0], ws[1], ws[2], c)
        attn = attn.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, tp, hp, wp, c)
        if any(ss):
            attn = torch.roll(attn, shifts=ss, dims=(1, 2, 3))
        x = shortcut + self.drop_path(attn[:, :t, :hh, :ww_], keep_attn)

        y = self.mlp_fc1(self.norm2(x))
        y = F.gelu(y, approximate="tanh" if y.dtype == torch.bfloat16 else "none")
        return x + self.drop_path(self.mlp_fc2(y), keep_mlp)


class PatchMerging(nn.Module):
    """Spatial 2x downsample, C -> 2C."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, _, h, w, _ = x.shape                 # x: (B, T, H, W, C)
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                       x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x))


class VideoSwin(nn.Module):
    """(B*T, 3, H, W) frames -> 4 levels of (B*T, C_s, H/s, W/s).

    ``num_frames`` fixes T (the 2D Swin's 1); left None, the caller passes
    the clip's T to ``forward``."""

    def __init__(self, embed_dim: int, depths: Tuple[int, ...], num_heads: Tuple[int, ...],
                 window_size: Window = (8, 7, 7), num_frames: Optional[int] = None,
                 use_checkpoint: bool = False):
        super().__init__()
        self.embed_dim = embed_dim
        self.depths = tuple(depths)
        self.num_frames = num_frames
        self.use_checkpoint = use_checkpoint
        self.patch_embed = nn.Conv2d(3, embed_dim, 4, stride=4)
        self.patch_norm = LayerNorm(embed_dim)
        rates = np.linspace(0, DROP_PATH_RATE, sum(self.depths))
        for stage, (depth, heads) in enumerate(zip(self.depths, num_heads)):
            dim = embed_dim * 2 ** stage
            for i in range(depth):
                setattr(self, f"stage{stage}_block{i}",
                        SwinBlock3D(dim, heads, window_size, shift=(i % 2 == 1),
                                    drop_path=float(rates[sum(self.depths[:stage]) + i])))
            if stage < len(self.depths) - 1:
                setattr(self, f"downsample{stage}", PatchMerging(dim))

    @property
    def num_channels(self) -> Tuple[int, ...]:
        return tuple(self.embed_dim * 2 ** i for i in range(len(self.depths)))

    def forward(self, frames: torch.Tensor, num_frames: Optional[int] = None):
        t = self.num_frames or num_frames
        bt, _, hh, ww = frames.shape
        b = bt // t
        # flax 'SAME' padding of the 4x4 stride-4 patch conv: the odd pixel after
        ph, pw = -hh % 4, -ww % 4
        x = F.pad(frames, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        x = self.patch_embed(x).permute(0, 2, 3, 1)
        x = self.patch_norm(x)
        x = x.reshape(b, t, x.shape[1], x.shape[2], self.embed_dim)
        outs = []
        for stage, depth in enumerate(self.depths):
            for i in range(depth):
                block = getattr(self, f"stage{stage}_block{i}")
                keep = (block.drop_path.draw(b, x.device), block.drop_path.draw(b, x.device))
                if self.use_checkpoint and torch.is_grad_enabled():
                    # the block draws nothing itself, so no generator state to restore
                    x = checkpoint(block, x, *keep, use_reentrant=False,
                                   preserve_rng_state=False)
                else:
                    x = block(x, *keep)
            outs.append(x.reshape(b * t, *x.shape[2:]).permute(0, 3, 1, 2))
            if stage < len(self.depths) - 1:
                x = getattr(self, f"downsample{stage}")(x)
        return tuple(outs)


_CONFIGS = {
    "video_swin_t_p4w7": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24)),
    "video_swin_s_p4w7": dict(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24)),
    "video_swin_b_p4w7": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)),
    # reduced arch for the parity tests
    "video_swin_test": dict(embed_dim=32, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8)),
}


def build_video_swin(arch: str, use_checkpoint: bool = False) -> VideoSwin:
    return VideoSwin(use_checkpoint=use_checkpoint, **_CONFIGS[arch])


def _from_config(cfg) -> VideoSwin:
    return build_video_swin(cfg.backbone, use_checkpoint=cfg.use_checkpoint)


BACKBONES = dict.fromkeys(_CONFIGS, _from_config)
