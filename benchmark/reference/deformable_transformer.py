"""Deformable transformer encoder/decoder: counterpart of
``ocpg_tpu/models/deformable_transformer.py``.

The attention modules build the channel-major MSDA inputs as the JAX
package does: one transpose of each Linear output to (N, C_out, Lq), the
``sampling_offsets`` channels ordered (m, l, p, xy), softmax over l*p, the
value zeroed at padding, and 2- or 4-dim reference points.  The sampling
math is float32; the value stays in the compute dtype.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .plain_ops import ms_deform_attn_cm
from .layers import MLP, Dropout, MultiheadAttention, float32_island, inverse_sigmoid

Shapes = Tuple[Tuple[int, int], ...]


def offset_bias(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Directional grid init of the sampling offsets' bias."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid.reshape(n_heads, 1, 1, 2), (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1).astype(np.float32)


class MSDeformAttnModule(nn.Module):
    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4):
        super().__init__()
        self.m, self.l, self.p = n_heads, n_levels, n_points
        self.value_proj = nn.Linear(d_model, d_model)
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.output_proj = nn.Linear(d_model, d_model)

    def forward(self, query: torch.Tensor,            # (N, Lq, C)
                reference_points: torch.Tensor,       # (N, Lq, L, 2 | 4) in [0, 1]
                input_flatten: torch.Tensor,          # (N, S, C)
                spatial_shapes: Shapes,
                input_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n, lq, c = query.shape
        m, l, p = self.m, self.l, self.p
        value = self.value_proj(input_flatten)
        if input_padding_mask is not None:
            value = value.masked_fill(input_padding_mask[..., None], 0.0)
        value = value.reshape(n, -1, m, c // m).contiguous()

        with float32_island(query):
            qf = query.float()
            offsets = self.sampling_offsets(qf).transpose(1, 2).reshape(n, m, l, p, 2, lq)
            attn = self.attention_weights(qf).transpose(1, 2).reshape(n, m, l * p, lq)
            aw_cm = torch.softmax(attn, dim=2).reshape(n, m, l, p, lq)

            ref = reference_points.float().permute(0, 2, 3, 1)   # (N, L, c, Lq)
            off_x, off_y = offsets[:, :, :, :, 0], offsets[:, :, :, :, 1]
            if reference_points.shape[-1] == 2:
                ws = torch.tensor([w for _, w in spatial_shapes], dtype=torch.float32,
                                  device=query.device)
                hs = torch.tensor([h for h, _ in spatial_shapes], dtype=torch.float32,
                                  device=query.device)
                x_cm = ref[:, None, :, 0, None, :] + off_x / ws[None, None, :, None, None]
                y_cm = ref[:, None, :, 1, None, :] + off_y / hs[None, None, :, None, None]
            elif reference_points.shape[-1] == 4:
                x_cm = ref[:, None, :, 0, None, :] + off_x / p * ref[:, None, :, 2, None, :] * 0.5
                y_cm = ref[:, None, :, 1, None, :] + off_y / p * ref[:, None, :, 3, None, :] * 0.5
            else:
                raise ValueError(f"reference points of shape {tuple(reference_points.shape)}")

        out = ms_deform_attn_cm(value, spatial_shapes, x_cm.contiguous(),
                                y_cm.contiguous(), aw_cm.contiguous())
        return self.output_proj(out)


class EncoderLayer(nn.Module):
    def __init__(self, d_model, d_ffn, n_levels, n_heads, n_points, dropout=0.1):
        super().__init__()
        self.self_attn = MSDeformAttnModule(d_model, n_levels, n_heads, n_points)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout1, self.dropout2, self.dropout3 = (Dropout(dropout) for _ in range(3))

    def forward(self, src, pos, reference_points, spatial_shapes, padding_mask):
        src2 = self.self_attn(src + pos, reference_points, src, spatial_shapes, padding_mask)
        src = self.norm1(src + self.dropout1(src2))
        ffn = self.linear2(self.dropout2(F.relu(self.linear1(src))))
        return self.norm2(src + self.dropout3(ffn))


class DecoderLayer(nn.Module):
    def __init__(self, d_model, d_ffn, n_levels, n_heads, n_points, dropout=0.1):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, n_heads, dropout)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.cross_attn = MSDeformAttnModule(d_model, n_levels, n_heads, n_points)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout1, self.dropout2, self.dropout3, self.dropout4 = (
            Dropout(dropout) for _ in range(4))

    def forward(self, tgt, query_pos, reference_points, src, spatial_shapes,
                src_padding_mask):
        q = tgt + query_pos
        tgt = self.norm2(tgt + self.dropout1(self.self_attn(q, q, tgt)))
        tgt2 = self.cross_attn(tgt + query_pos, reference_points, src, spatial_shapes,
                               src_padding_mask)
        tgt = self.norm1(tgt + self.dropout2(tgt2))
        ffn = self.linear2(self.dropout3(F.relu(self.linear1(tgt))))
        return self.norm3(tgt + self.dropout4(ffn))


def encoder_reference_points(spatial_shapes: Shapes,
                             valid_ratios: torch.Tensor) -> torch.Tensor:
    """Per-pixel reference points.  valid_ratios (N, L, 2) as (w, h);
    returns (N, S, L, 2)."""
    dev = valid_ratios.device
    points = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        ref_y = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)[:, None]
        ref_x = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5)[None, :]
        ref_y = ref_y.expand(h, w).reshape(-1)[None] / (valid_ratios[:, None, lvl, 1] * h)
        ref_x = ref_x.expand(h, w).reshape(-1)[None] / (valid_ratios[:, None, lvl, 0] * w)
        points.append(torch.stack((ref_x, ref_y), -1))
    ref = torch.cat(points, 1)
    return ref[:, :, None] * valid_ratios[:, None]


def get_valid_ratio(mask: torch.Tensor) -> torch.Tensor:
    """Non-padding ratio per (w, h); mask (N, H, W), True = pad."""
    not_mask = ~mask
    valid_h = not_mask[:, :, 0].sum(1).float()
    valid_w = not_mask[:, 0, :].sum(1).float()
    return torch.stack([valid_w / mask.shape[2], valid_h / mask.shape[1]], -1)


class DeformableTransformer(nn.Module):
    def __init__(self, d_model: int = 256, nhead: int = 8, num_encoder_layers: int = 4,
                 num_decoder_layers: int = 4, dim_feedforward: int = 2048,
                 dropout: float = 0.1, num_feature_levels: int = 4, dec_n_points: int = 4,
                 enc_n_points: int = 4, with_box_refine: bool = True):
        super().__init__()
        self.num_encoder_layers = num_encoder_layers
        self.num_decoder_layers = num_decoder_layers
        self.num_feature_levels = num_feature_levels
        self.with_box_refine = with_box_refine
        self.level_embed = nn.Parameter(torch.zeros(num_feature_levels, d_model))
        for i in range(num_encoder_layers):
            setattr(self, f"encoder_layer_{i}", EncoderLayer(
                d_model, dim_feedforward, num_feature_levels, nhead, enc_n_points, dropout))
        self.reference_points = nn.Linear(d_model, 2)
        for i in range(num_decoder_layers):
            setattr(self, f"decoder_layer_{i}", DecoderLayer(
                d_model, dim_feedforward, num_feature_levels, nhead, dec_n_points, dropout))
            if with_box_refine:
                setattr(self, f"bbox_embed_{i}", MLP(d_model, d_model, 4, 3))

    def forward(self, srcs: Sequence[torch.Tensor],        # L x (N, C, H, W)
                tgt: torch.Tensor,                         # (N, Q, C)
                masks: Sequence[torch.Tensor],             # L x (N, H, W) True = pad
                pos_embeds: Sequence[torch.Tensor],        # L x (N, H, W, C)
                query_embed: torch.Tensor,                 # (Q, C)
                ) -> Dict[str, object]:
        spatial_shapes: Shapes = tuple((int(s.shape[2]), int(s.shape[3])) for s in srcs)
        src_flat = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], 1)
        mask_flat = torch.cat([m.flatten(1) for m in masks], 1)
        pos_flat = torch.cat([p.flatten(1, 2) + self.level_embed[i][None, None].to(p.dtype)
                              for i, p in enumerate(pos_embeds)], 1)
        valid_ratios = torch.stack([get_valid_ratio(m) for m in masks], 1)   # (N, L, 2)

        output = src_flat
        enc_ref = encoder_reference_points(spatial_shapes, valid_ratios)
        for i in range(self.num_encoder_layers):
            output = getattr(self, f"encoder_layer_{i}")(
                output, pos_flat, enc_ref, spatial_shapes, mask_flat)
        memory = output

        n = memory.shape[0]
        query_pos = query_embed[None].expand(n, -1, -1)
        with float32_island(memory):
            reference_points = torch.sigmoid(self.reference_points(query_pos.float()))
        init_reference = reference_points

        hs_layers: List[torch.Tensor] = []
        refs_layers: List[torch.Tensor] = []
        coords_layers: List[torch.Tensor] = []
        out_q = tgt
        for i in range(self.num_decoder_layers):
            if reference_points.shape[-1] == 4:
                ref_input = reference_points[:, :, None] * torch.cat(
                    [valid_ratios, valid_ratios], -1)[:, None]
            else:
                ref_input = reference_points[:, :, None] * valid_ratios[:, None]
            out_q = getattr(self, f"decoder_layer_{i}")(
                out_q, query_pos, ref_input, memory, spatial_shapes, mask_flat)
            if self.with_box_refine:
                with float32_island(out_q):
                    tmp = getattr(self, f"bbox_embed_{i}")(out_q.float())
                    if reference_points.shape[-1] == 4:
                        new_ref = torch.sigmoid(tmp + inverse_sigmoid(reference_points))
                    else:
                        new_ref = torch.sigmoid(torch.cat(
                            [tmp[..., :2] + inverse_sigmoid(reference_points), tmp[..., 2:]],
                            -1))
                coords_layers.append(new_ref)
                reference_points = new_ref.detach()
            hs_layers.append(out_q)
            refs_layers.append(reference_points)

        memory_features = []
        start = 0
        for lvl in range(self.num_feature_levels - 1):
            h, w = spatial_shapes[lvl]
            memory_features.append(
                memory[:, start:start + h * w].transpose(1, 2).reshape(n, -1, h, w))
            start += h * w

        return {
            "hs": torch.stack(hs_layers),                     # (Ldec, N, Q, C)
            "memory_features": memory_features,               # NCHW, levels 0..L-2
            "init_reference": init_reference,
            "inter_references": torch.stack(refs_layers),     # (Ldec, N, Q, 2 | 4)
            "inter_coords": torch.stack(coords_layers) if self.with_box_refine else None,
        }
