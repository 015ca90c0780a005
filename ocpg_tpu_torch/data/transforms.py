"""Clip-joint video transforms on the host: counterpart of
``ocpg_tpu/data/transforms.py``.

Every op acts jointly on frames, boxes, masks, weak masks and heatmaps, as
the reference's ``transforms_video`` does: ``random_resize`` (shorter side
to a scale, longer side capped), ``random_size_crop`` (boxes clamped, then
``check_validity``), ``random_hflip`` (pixels, boxes and "left" <-> "right"
in the caption), ``photometric_distort``, ``normalize`` (ImageNet mean and
std, boxes to normalised cxcywh).  ``train_transform`` and
``val_transform`` are the reference's recipes; ``pad_to_canvas`` pads a
clip to one fixed canvas and records the pad mask.

The JAX package resizes and converts colors with cv2.  Here both are numpy,
so the train path needs no cv2, and each reproduces cv2's result on the
dtypes the pipeline carries (float32 frames, masks and heatmaps, uint8
colors):

* ``INTER_NEAREST`` (masks): source index ``floor(d * (1 / (dst / src)))``
  in double, clamped to the last row or column; exact.
* ``INTER_LINEAR`` (frames, heatmaps): half-pixel centres, the fraction
  computed in double and rounded to float32, a horizontal then a vertical
  pass, each ``a + (b - a) * t`` with one fused multiply-add in float32;
  at the left and right edges the column clamps with fraction 0, at the
  top and bottom the row index clamps and the fraction stays.  An exact
  2x downscale is then the mean of each 2x2 block; cv2 4.x computes it as
  ``INTER_AREA`` (the same mean, another rounding), cv2 5.0 by this linear
  path.  Bit-exact against cv2 5.0 on sources of two rows or more (a
  one-row source takes another path in cv2, within a few float32 steps of
  this one).
* ``RGB2HSV`` on uint8: cv2's integer arithmetic with its tables
  (``hsv_shift = 12``, ``sdiv_table``, ``hdiv_table180``); exact.
* ``HSV2RGB`` on uint8 with H in [0, 180): float32 with two fused
  multiply-adds, truncated to uint8 in 32-pixel blocks and rounded in each
  row's last ``W mod 32`` pixels, as cv2 5.0's AVX2 build computes it;
  exact.

Every random draw comes from the ``random.Random`` handed in, in the JAX
code's order, draw for draw.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

TRAIN_SCALES = [288, 320, 352, 392, 416, 448, 480, 512]


@dataclasses.dataclass
class Clip:
    """Mutable clip record passing through the transform pipeline.

    frames: (T, H, W, 3) float32 (0..255); boxes: (T, 4) absolute xyxy;
    masks/weak_masks/weights: (T, H, W) float32; valid: (T,); caption: str.
    """
    frames: np.ndarray
    boxes: np.ndarray
    masks: np.ndarray
    weak_masks: np.ndarray
    weights: np.ndarray
    valid: np.ndarray
    labels: np.ndarray
    caption: str

    @property
    def size(self) -> Tuple[int, int]:
        return self.frames.shape[1], self.frames.shape[2]


# --------------------------------------------------------------- resizes --
def _nearest_index(src: int, dst: int) -> np.ndarray:
    """cv2 INTER_NEAREST's source index per output index (resizeNN)."""
    scale = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * scale).astype(np.int64), src - 1)


def resize_nearest(x: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(f, (w, h), interpolation=cv2.INTER_NEAREST)`` of every
    frame of a (T, H, W, ...) stack."""
    oh, ow = size
    rows = np.take(x, _nearest_index(x.shape[1], oh), axis=1)
    return np.take(rows, _nearest_index(x.shape[2], ow), axis=2)


def _linear_taps(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray]:
    """cv2 INTER_LINEAR's first source index and float32 fraction per output
    index: ``f = (d + 0.5) * scale - 0.5`` in double with
    ``scale = 1 / (dst / src)``, ``i = floor(f)``, the fraction ``f - i``
    rounded to float32."""
    scale = 1.0 / (dst / src)
    f = (np.arange(dst) + 0.5) * scale - 0.5
    i = np.floor(f)
    return i.astype(np.int64), (f - i).astype(np.float32)


def resize_linear(x: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(f, (w, h), interpolation=cv2.INTER_LINEAR)`` of every
    frame of a float32 (T, H, W) or (T, H, W, C) stack (see the module
    docstring)."""
    if x.dtype != np.float32:
        raise TypeError(f"resize_linear computes cv2's float32 path; got {x.dtype}")
    h, w = x.shape[1:3]
    oh, ow = size
    if (oh, ow) == (h, w):
        return x.copy()
    chan = x.shape[3:]
    # horizontal pass: a column left of 0 or at or past the last one clamps
    # with fraction 0 (cv2 then reads that column alone)
    i, f = _linear_taps(w, ow)
    f = np.where((i < 0) | (i >= w - 1), np.float32(0), f)
    i = np.clip(i, 0, w - 1)
    tmp = _lerp(np.take(x, i, axis=2), np.take(x, np.minimum(i + 1, w - 1), axis=2),
                f.reshape((ow,) + (1,) * len(chan)))
    # vertical pass: the rows clamp, the fractions stay
    j, g = _linear_taps(h, oh)
    return _lerp(np.take(tmp, np.clip(j, 0, h - 1), axis=1),
                 np.take(tmp, np.clip(j + 1, 0, h - 1), axis=1),
                 g.reshape((oh, 1) + (1,) * len(chan)))


def _lerp(a: np.ndarray, b: np.ndarray, t: np.ndarray) -> np.ndarray:
    """``a + (b - a) * t`` of float32 arrays as cv2's vectorised linear
    passes compute it: the difference rounded to float32, then one fused
    multiply-add (emulated in float64, where the float32 product is exact)."""
    out = np.multiply(b - a, t, dtype=np.float64)
    out += a
    return out.astype(np.float32)


def _resize_clip(clip: Clip, size: Tuple[int, int]) -> Clip:
    h, w = clip.size
    oh, ow = size
    if (oh, ow) == (h, w):
        return clip
    clip.frames = resize_linear(clip.frames, size)
    clip.masks = resize_nearest(clip.masks, size)
    clip.weak_masks = resize_nearest(clip.weak_masks, size)
    clip.weights = resize_linear(clip.weights, size)
    sx, sy = ow / w, oh / h
    clip.boxes = clip.boxes * np.array([sx, sy, sx, sy], np.float32)
    return clip


def _target_size(h: int, w: int, size: int, max_size: Optional[int]) -> Tuple[int, int]:
    """torchvision-style shorter-side resize with longer-side cap."""
    short, long = (h, w) if h < w else (w, h)
    if max_size is not None and size / short * long > max_size:
        size = int(round(max_size * short / long))
    if h < w:
        oh, ow = size, int(round(size * w / h))
    else:
        ow, oh = size, int(round(size * h / w))
    return oh, ow


def random_resize(clip: Clip, scales: List[int], max_size: Optional[int] = None,
                  rng: Optional[random.Random] = None) -> Clip:
    rng = rng or random
    size = rng.choice(scales)
    return _resize_clip(clip, _target_size(*clip.size, size, max_size))


def random_size_crop(clip: Clip, min_size: int, max_size: int,
                     rng: Optional[random.Random] = None) -> Clip:
    rng = rng or random
    h, w = clip.size
    cw = rng.randint(min_size, min(w, max_size))
    ch = rng.randint(min_size, min(h, max_size))
    y0 = rng.randint(0, h - ch)
    x0 = rng.randint(0, w - cw)

    clip.frames = clip.frames[:, y0:y0 + ch, x0:x0 + cw]
    clip.masks = clip.masks[:, y0:y0 + ch, x0:x0 + cw]
    clip.weak_masks = clip.weak_masks[:, y0:y0 + ch, x0:x0 + cw]
    clip.weights = clip.weights[:, y0:y0 + ch, x0:x0 + cw]
    boxes = clip.boxes - np.array([x0, y0, x0, y0], np.float32)
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, cw)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, ch)
    clip.boxes = boxes
    return check_validity(clip)


def check_validity(clip: Clip) -> Clip:
    """Recompute per-frame ``valid`` after spatial edits."""
    area = (clip.boxes[:, 2] - clip.boxes[:, 0]) * (clip.boxes[:, 3] - clip.boxes[:, 1])
    has_mask = clip.masks.reshape(clip.masks.shape[0], -1).sum(-1) > 0
    clip.valid = ((area > 0) & has_mask).astype(np.int32)
    return clip


def random_hflip(clip: Clip, p: float = 0.5, rng: Optional[random.Random] = None) -> Clip:
    rng = rng or random
    if rng.random() >= p:
        return clip
    h, w = clip.size
    clip.frames = clip.frames[:, :, ::-1].copy()
    clip.masks = clip.masks[:, :, ::-1].copy()
    clip.weak_masks = clip.weak_masks[:, :, ::-1].copy()
    clip.weights = clip.weights[:, :, ::-1].copy()
    b = clip.boxes.copy()
    b[:, 0], b[:, 2] = w - clip.boxes[:, 2], w - clip.boxes[:, 0]
    clip.boxes = b
    clip.caption = (
        clip.caption.replace("left", "@").replace("right", "left").replace("@", "right")
    )
    return clip


# ---------------------------------------------------------------- colors --
_HSV_SHIFT = 12
_I = np.arange(1, 256, dtype=np.float64)
# cv2's RGB2HSV_b tables (saturate_cast<int> of a double rounds half to even)
_SDIV = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) / _I)]).astype(np.int64)
_HDIV180 = np.concatenate([[0], np.rint((180 << _HSV_SHIFT) / (6.0 * _I))]).astype(np.int64)
# 6.0f / 180 and 1.0f / 255.0f as cv2's HSV2RGB_b holds them
_HSCALE = np.float32(6.0) / np.float32(180)
_INV255 = np.float32(1.0) / np.float32(255.0)


def rgb_to_hsv_u8(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2HSV)`` of uint8 (..., 3) RGB: uint8
    HSV, H in [0, 180)."""
    rgb = img.astype(np.int64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV180[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([np.clip(h, 0, 255), s, v], -1).astype(np.uint8)


def _fnma(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``1 - a * b`` of float32 arrays rounded once, as a fused multiply-add
    rounds it (the float32 product is exact in float64)."""
    return (1.0 - a.astype(np.float64) * b).astype(np.float32)


def hsv_to_rgb_u8(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(frame, cv2.COLOR_HSV2RGB)`` of each (H, W, 3) uint8 HSV
    frame of a (..., H, W, 3) stack, H in [0, 180): uint8 RGB.  As cv2 5.0
    computes it: float32 with the two ``1 - s * h`` terms fused; each row
    converted in blocks of 32 pixels, which truncate ``x * 255``, and its
    last ``W mod 32`` pixels one at a time, which round it half to even."""
    h = hsv[..., 0].astype(np.float32) * _HSCALE
    s = hsv[..., 1].astype(np.float32) * _INV255
    v = hsv[..., 2].astype(np.float32) * _INV255
    sector = np.floor(h)
    h = h - sector
    sector = sector.astype(np.int64) % 6
    one = np.float32(1)
    tab = np.stack([v, v * (one - s), v * _fnma(s, h), v * _fnma(s, one - h)])
    # (b, g, r) entries of tab per sector, cv2's sector_data
    order = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])
    bgr = np.take_along_axis(tab, np.moveaxis(order[sector], -1, 0), axis=0)
    rgb = np.stack([bgr[2], bgr[1], bgr[0]], -1) * np.float32(255.0)
    w = hsv.shape[-2]
    tail = (np.arange(w) >= w - w % 32)[:, None]
    return np.clip(np.where(tail, np.rint(rgb), np.floor(rgb)), 0, 255).astype(np.uint8)


def photometric_distort(clip: Clip, rng: Optional[random.Random] = None) -> Clip:
    rng = rng or random
    img = clip.frames.astype(np.float32)
    if rng.random() < 0.5:
        img += rng.uniform(-32, 32)
    if rng.random() < 0.5:
        img *= rng.uniform(0.5, 1.5)
    img = img.clip(0, 255)
    if rng.random() < 0.5:
        hsv = rgb_to_hsv_u8(img.astype(np.uint8)).astype(np.float32)
        hsv[..., 1] *= rng.uniform(0.5, 1.5)
        hsv[..., 0] += rng.uniform(-18, 18)
        hsv[..., 0] %= 180
        hsv = hsv.clip(0, 255).astype(np.uint8)
        img = hsv_to_rgb_u8(hsv).astype(np.float32)
    clip.frames = img
    return clip


def normalize(clip: Clip, images: bool = True) -> Clip:
    """To float [0, 1], ImageNet-normalised; boxes to normalised cxcywh.

    ``images=False`` leaves frames in 0..255 (the compact uint8 wire:
    ``loader.decompress_batch`` normalises on the device)."""
    if images:
        img = clip.frames.astype(np.float32)
        if img.max() > 2.0:
            img = img / 255.0
        clip.frames = (img - IMAGENET_MEAN) / IMAGENET_STD
    h, w = clip.size
    b = clip.boxes.astype(np.float32)
    cx = (b[:, 0] + b[:, 2]) / 2 / w
    cy = (b[:, 1] + b[:, 3]) / 2 / h
    bw = (b[:, 2] - b[:, 0]) / w
    bh = (b[:, 3] - b[:, 1]) / h
    clip.boxes = np.stack([cx, cy, bw, bh], -1)
    return clip


def train_transform(clip: Clip, max_size: int = 640,
                    rng: Optional[random.Random] = None,
                    photometric: bool = False,
                    normalize_images: bool = True) -> Clip:
    """The reference's train recipe: RandomSelect(resize | resize, crop,
    resize), then hflip and normalize."""
    rng = rng or random
    if rng.random() < 0.5:
        clip = random_resize(clip, TRAIN_SCALES, max_size, rng)
        clip = check_validity(clip)
    else:
        clip = random_resize(clip, [400, 500, 600], None, rng)
        clip = random_size_crop(clip, 384, 600, rng)
        clip = random_resize(clip, TRAIN_SCALES, max_size, rng)
        clip = check_validity(clip)
    clip = random_hflip(clip, 0.5, rng)
    if photometric:
        clip = photometric_distort(clip, rng)
    return normalize(clip, images=normalize_images)


def val_transform(clip: Clip, size: int = 360, max_size: int = 640,
                  normalize_images: bool = True) -> Clip:
    clip = _resize_clip(clip, _target_size(*clip.size, size, max_size))
    return normalize(clip, images=normalize_images)


def pad_to_canvas(clip: Clip, canvas: Tuple[int, int],
                  compact: bool = False) -> Dict[str, np.ndarray]:
    """Pad to a fixed (H, W) canvas (bottom/right) and emit the batch entry.

    ``compact=True`` emits the compact wire (see ``loader.decompress_batch``):
    frames as un-normalised uint8 RGB, binary masks and weak masks as
    uint8, heatmaps as float16, about a third of the bytes."""
    h, w = clip.size
    ch, cw = canvas
    if h > ch or w > cw:
        raise ValueError(f"clip {(h, w)} does not fit the canvas {canvas}")
    t = clip.frames.shape[0]

    def pad(x, dtype=np.float32):
        out = np.zeros((t, ch, cw) + x.shape[3:], dtype=dtype)
        out[:, :h, :w] = x
        return out

    mask = np.ones((t, ch, cw), bool)
    mask[:, :h, :w] = False
    if compact:
        frames = pad(np.rint(np.clip(clip.frames, 0, 255)), np.uint8)
        masks = pad(clip.masks, np.uint8)
        weights = pad(clip.weights, np.float16)
        weak = pad(clip.weak_masks, np.uint8)
    else:
        frames = pad(clip.frames)
        masks = pad(clip.masks)
        weights = pad(clip.weights)
        weak = pad(clip.weak_masks)
    return {
        "samples": frames,
        "samples_mask": mask,
        "targets": {
            "labels": clip.labels.astype(np.int32),
            "boxes": clip.boxes.astype(np.float32),
            "valid": clip.valid.astype(np.int32),
            "masks": masks,
            "weights": weights,
            "weak_masks": weak,
            "size": np.array([h, w], np.int32),
        },
        "caption": clip.caption,
    }


def canvas_for(max_size: int = 640, divisor: int = 32) -> Tuple[int, int]:
    """One fixed canvas covering every train/val scale (<=512 short, <=640 long)."""
    side = ((max_size + divisor - 1) // divisor) * divisor
    short = ((512 + divisor - 1) // divisor) * divisor
    return short, side
