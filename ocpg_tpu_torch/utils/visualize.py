"""Qualitative overlays for inference (``--visualize``): the port's copy of
``ocpg_tpu/utils/visualize.py`` (numpy and PIL).

The reference's inference scripts define ``draw_reference_points``,
``draw_sample_points`` and ``vis_add_mask`` with a Detectron-style
colormap, and allocate ``<output_dir>/<split>_images`` for them; the
inference CLIs here write per-frame RGB overlays of the predicted mask
(50/50 blend) with a cross at the model's reference point beside the
submission PNGs.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np

# Prefix of the published Detectron colormap (values * 255), cycled per
# object or expression.
COLORS: Tuple[Tuple[int, int, int], ...] = (
    (0, 113, 188), (216, 82, 24), (236, 176, 31), (125, 46, 141),
    (118, 171, 47), (76, 189, 237), (161, 19, 46), (76, 76, 76),
    (153, 153, 153), (255, 0, 0), (255, 127, 0), (190, 190, 0),
    (0, 255, 0), (0, 0, 255), (170, 0, 255), (84, 84, 0),
)


def vis_add_mask(img: np.ndarray, mask: np.ndarray,
                 color: Sequence[int]) -> np.ndarray:
    """50/50 blend of ``color`` into ``img`` where mask > 0.5.
    img: (H, W, 3) uint8; mask: (H, W)."""
    out = img.copy()
    sel = np.asarray(mask) > 0.5
    out[sel] = (out[sel] * 0.5 + np.asarray(color, np.float32) * 0.5).astype(np.uint8)
    return out


def draw_reference_points(draw, reference_points: Iterable[Tuple[float, float]],
                          img_size: Tuple[int, int], color: Sequence[int]) -> None:
    """A cross at each normalized (x, y) point.  draw: PIL.ImageDraw;
    img_size: (W, H)."""
    w, h = img_size
    for (init_x, init_y) in reference_points:
        x, y = w * float(init_x), h * float(init_y)
        draw.line((x - 10, y, x + 10, y), tuple(color), width=4)
        draw.line((x, y - 10, x, y + 10), tuple(color), width=4)


def draw_sample_points(draw, sample_points, img_size: Tuple[int, int],
                       color_list: Sequence[Sequence[int]] = COLORS) -> None:
    """Dots at pixel-space sampling points.  sample_points: iterable of
    per-group iterables of (x, y); ``img_size`` is the reference's
    signature's and unused (the points arrive in pixels)."""
    del img_size
    for i, samples in enumerate(sample_points):
        for (x, y) in samples:
            cur = list(color_list[i % len(color_list)][::-1]) + [255]
            draw.ellipse((x - 2, y - 2, x + 2, y + 2),
                         fill=tuple(cur), outline=tuple(cur), width=1)


def save_overlay(path, frame_rgb: np.ndarray, mask: np.ndarray,
                 color: Sequence[int],
                 ref_point_norm: Tuple[float, float] | None = None) -> None:
    """Blend and an optional reference-point cross, written as one PNG."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(vis_add_mask(frame_rgb, mask, color))
    if ref_point_norm is not None:
        draw_reference_points(ImageDraw.Draw(img), [ref_point_norm],
                              img.size, color)
    img.save(path)
