"""BoxInst pairwise color-similarity loss (opt-in): counterpart of
``ocpg_tpu/models/pairwise.py``.

The spatial BoxInst term and the temporal-neighbour terms, on the matched
query's 1/2-resolution mask logits, weighted by the Lab color similarity
of the frames at the same scale (``OCPGConfig.pairwise_loss``).  The patch
stacks are shifted slices of a zero-padded map, in ``F.unfold``'s order
(row-major over (ky, kx); index ``k * k // 2`` is the center); everything
is float32.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD

Tensor = torch.Tensor

# sRGB -> XYZ (D65) and the D65 white point, as skimage.color.rgb2lab uses them
_RGB2XYZ = ((0.412453, 0.357580, 0.180423),
            (0.212671, 0.715160, 0.072169),
            (0.019334, 0.119193, 0.950227))
_D65_WHITE = (0.95047, 1.0, 1.08883)


def unfold_w_center(x: Tensor, kernel_size: int, dilation: int) -> Tensor:
    """(B, C, H, W) -> (B, C, k*k, H, W) patch stack, zero padded to the same size."""
    if kernel_size % 2 != 1:
        raise ValueError(f"kernel_size must be odd, got {kernel_size}")
    h, w = x.shape[2:]
    pad = (kernel_size + (dilation - 1) * (kernel_size - 1)) // 2
    xp = F.pad(x, (pad, pad, pad, pad))
    return torch.stack([xp[:, :, ky * dilation:ky * dilation + h, kx * dilation:kx * dilation + w]
                        for ky in range(kernel_size) for kx in range(kernel_size)], dim=2)


def unfold_wo_center(x: Tensor, kernel_size: int, dilation: int) -> Tensor:
    """``unfold_w_center`` without the center: (B, C, k*k - 1, H, W)."""
    u = unfold_w_center(x, kernel_size, dilation)
    half = kernel_size ** 2 // 2
    return torch.cat([u[:, :, :half], u[:, :, half + 1:]], dim=2)


def compute_pairwise_term(mask_logits: Tensor, pairwise_size: int,
                          pairwise_dilation: int) -> Tensor:
    """-log P(center and neighbour take the same label), per neighbour:
    (B, 1, H, W) -> (B, k*k - 1, H, W)."""
    log_fg = F.logsigmoid(mask_logits)
    log_bg = F.logsigmoid(-mask_logits)
    log_same_fg = log_fg[:, :, None] + unfold_wo_center(log_fg, pairwise_size, pairwise_dilation)
    log_same_bg = log_bg[:, :, None] + unfold_wo_center(log_bg, pairwise_size, pairwise_dilation)
    return -torch.logaddexp(log_same_fg, log_same_bg)[:, 0]


def compute_pairwise_term_neighbor(mask_logits: Tensor, mask_logits_neighbor: Tensor,
                                   pairwise_size: int, pairwise_dilation: int) -> Tensor:
    """The temporal variant: the center from the neighbour frame, the
    patches (center kept) from this one.  (B, 1, H, W) x 2 -> (B, k*k, H, W)."""
    log_fg = unfold_w_center(F.logsigmoid(mask_logits), pairwise_size, pairwise_dilation)
    log_bg = unfold_w_center(F.logsigmoid(-mask_logits), pairwise_size, pairwise_dilation)
    log_same_fg = F.logsigmoid(mask_logits_neighbor)[:, :, None] + log_fg
    log_same_bg = F.logsigmoid(-mask_logits_neighbor)[:, :, None] + log_bg
    return -torch.logaddexp(log_same_fg, log_same_bg)[:, 0]


def get_images_color_similarity(images: Tensor, kernel_size: int, dilation: int) -> Tensor:
    """exp(-||center - neighbour|| / 2) per non-center neighbour:
    (B, C, H, W) -> (B, k*k - 1, H, W)."""
    diff = images[:, :, None] - unfold_wo_center(images, kernel_size, dilation)
    return torch.exp(-torch.linalg.vector_norm(diff, dim=1) * 0.5)


def get_neighbor_images_color_similarity(images: Tensor, images_neighbor: Tensor,
                                         kernel_size: int, dilation: int) -> Tensor:
    """Cross-frame similarity, center kept: (B, C, H, W) x 2 -> (B, k*k, H, W)."""
    diff = images_neighbor[:, :, None] - unfold_w_center(images, kernel_size, dilation)
    return torch.exp(-torch.linalg.vector_norm(diff, dim=1) * 0.5)


def get_neighbor_images_patch_color_similarity(images: Tensor, images_neighbor: Tensor,
                                               kernel_size: int, dilation: int) -> Tensor:
    """Patch-level cross-frame similarity: both frames unfolded with
    dilation 1 (the reference ignores ``dilation`` here, and so does the
    JAX package), channels x patches flattened, then the k = 3, d = 3
    neighbour similarity of those descriptors.  -> (B, 9, H, W)."""
    del dilation
    u = unfold_w_center(images, kernel_size, 1)
    un = unfold_w_center(images_neighbor, kernel_size, 1)
    b, c, kk, h, w = u.shape
    return get_neighbor_images_color_similarity(u.reshape(b, c * kk, h, w),
                                                un.reshape(b, c * kk, h, w), 3, 3)


def rgb2lab(rgb: Tensor) -> Tensor:
    """CIE Lab (D65, 2-degree observer) from sRGB in [0, 1]; channels last."""
    rgb = rgb.float()
    linear = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4, rgb / 12.92)
    xyz = linear @ torch.tensor(_RGB2XYZ, device=rgb.device).T
    t = xyz / torch.tensor(_D65_WHITE, device=rgb.device)
    f = torch.where(t > 0.008856, t.clamp(min=0.008856) ** (1.0 / 3.0),
                    7.787 * t + 16.0 / 116.0)
    return torch.stack([116.0 * f[..., 1] - 16.0,
                        500.0 * (f[..., 0] - f[..., 1]),
                        200.0 * (f[..., 1] - f[..., 2])], dim=-1)


def normalized_rgb_to_lab(img_norm: Tensor) -> Tensor:
    """ImageNet-normalised RGB (..., 3) -> Lab, through uint8 as the
    reference's ``transform_images`` quantises (``.byte()`` before rgb2lab;
    clipped to 0..255 first, as the JAX package does)."""
    mean = torch.from_numpy(IMAGENET_MEAN).to(img_norm.device)
    std = torch.from_numpy(IMAGENET_STD).to(img_norm.device)
    rgb = ((img_norm.float() * std + mean) * 255.0).clamp(0.0, 255.0).to(torch.uint8)
    return rgb2lab(rgb.float() / 255.0)


def pairwise_losses(mask_logits: Tensor, img_norm: Tensor, box_region: Tensor,
                    color_thresh: float = 0.05) -> Dict[str, Tensor]:
    """``loss_pairwise`` and ``loss_pairwise_neighbor``.

    mask_logits (B, T, H, W); img_norm (B, T, H, W, 3) normalised RGB at
    the same scale; box_region (B, T, H, W) binary box masks.  Spatial term
    per frame (k = 3, d = 2), weighted by (Lab similarity >= color_thresh) x
    box region.  Temporal terms over the frame triplets (ii, ii+1, ii+2),
    stride 3, with the patch similarity (k = 3, d = 3), weighted where the
    box region covers more than one frame of the clip; each pair normalised
    by its own weight mass, then averaged.  Frames after the last full
    triplet add only the spatial term; under 3 frames the temporal loss is 0.
    """
    b, t, h, w = mask_logits.shape
    lab = normalized_rgb_to_lab(img_norm)                          # (B, T, H, W, 3)
    lab_f = lab.reshape(b * t, h, w, 3).permute(0, 3, 1, 2)
    logits = mask_logits.float()
    region_f = box_region.reshape(b * t, 1, h, w)

    sim = get_images_color_similarity(lab_f, 3, 2)
    pw = compute_pairwise_term(logits.reshape(b * t, 1, h, w), 3, 2)
    weights = (sim >= color_thresh).float() * region_f
    out = {"loss_pairwise": (pw * weights).sum() / weights.sum().clamp(min=1.0)}
    if t < 3:
        out["loss_pairwise_neighbor"] = torch.zeros((), device=logits.device)
        return out

    region_sum = (box_region.sum(dim=1, keepdim=True) > 1.0).float()   # (B, 1, H, W)
    lab_bt = lab.permute(0, 1, 4, 2, 3)                                 # (B, T, 3, H, W)
    logits_b = logits[:, :, None]                                       # (B, T, 1, H, W)
    terms = []
    for ii in range(0, t - 2, 3):
        for i, j in ((ii, ii + 1), (ii, ii + 2), (ii + 1, ii + 2)):
            psim = get_neighbor_images_patch_color_similarity(lab_bt[:, i], lab_bt[:, j], 3, 3)
            pwn = compute_pairwise_term_neighbor(logits_b[:, i], logits_b[:, j], 3, 3)
            wn = (psim >= color_thresh).float() * region_sum
            terms.append((pwn * wn).sum() / wn.sum().clamp(min=1.0))
    out["loss_pairwise_neighbor"] = sum(terms) / len(terms)
    return out
