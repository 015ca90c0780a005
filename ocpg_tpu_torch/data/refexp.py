"""RefCOCO/+/g pretraining datasets: counterpart of ``ocpg_tpu/data/refexp.py``.

COCO-format referring detection (the reference's ``datasets/refexp.py``:
retry-until-valid is the loader's, one image is a T=1 clip) and the
pseudo-video form (``refexp2seq.py`` with ``image_to_seq_augmenter.py``):
one image warped into T frames by perspective, affine and motion-blur
warps, then shuffled.  As in the JAX package the augmenter is cv2's affine
and perspective warps with imgaug's parameter ranges, and COCO polygons are
rasterised with ``cv2.fillPoly``; cv2 is imported by the call that needs
it.  Compressed RLE segmentations decode through the native library
(``native/io.py``), or this module's own copy of the COCO string codec
where the library is not built.
"""

from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from ..native import io as _native
from .datasets import ClipRecord, mask_bounding_box
from .imageio import read_rgb
from .transforms import Clip


def _rle_counts(s) -> List[int]:
    """COCO's compressed RLE string -> run lengths (modified LEB128, deltas
    against counts[i - 2] from the third run on)."""
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts: List[int] = []
    i = 0
    while i < len(s):
        x, k, more = 0, 0, True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def _runs_to_mask(counts: List[int], h: int, w: int) -> np.ndarray:
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((h, w), order="F")


def polygons_to_mask(segm, h: int, w: int) -> np.ndarray:
    """COCO polygon / RLE segmentation -> binary mask."""
    mask = np.zeros((h, w), np.uint8)
    if isinstance(segm, list):
        import cv2

        for poly in segm:
            pts = np.asarray(poly, np.float64).reshape(-1, 2)
            cv2.fillPoly(mask, [pts.astype(np.int32)], 1)
    elif isinstance(segm, dict):
        counts = segm["counts"]
        rh, rw = segm["size"]
        if isinstance(counts, list):  # uncompressed RLE
            mask = _runs_to_mask(counts, h, w)
        elif _native.available():
            mask = _native.rle_decode_str(counts, int(rh), int(rw))
        else:
            mask = _runs_to_mask(_rle_counts(counts), int(rh), int(rw))
    return mask.astype(np.float32)


class ImageToSeqAugmenter:
    """One image -> T warped frames (image_to_seq_augmenter.py:18-100, cv2)."""

    def __init__(self, perspective: bool = True, affine: bool = True,
                 motion_blur: bool = True,
                 rotation_range: Tuple[float, float] = (-20, 20),
                 perspective_magnitude: float = 0.08,
                 translate_range: Tuple[float, float] = (-0.1, 0.1),
                 motion_blur_kernel_sizes: Tuple[int, ...] = (7, 9),
                 motion_blur_prob: float = 0.5):
        self.perspective = perspective
        self.affine = affine
        self.motion_blur = motion_blur
        self.rotation_range = rotation_range
        self.perspective_magnitude = perspective_magnitude
        self.translate_range = translate_range
        self.motion_blur_kernel_sizes = motion_blur_kernel_sizes
        self.motion_blur_prob = motion_blur_prob

    def __call__(self, image: np.ndarray, mask: np.ndarray,
                 rng: random.Random) -> Tuple[np.ndarray, np.ndarray]:
        import cv2

        h, w = image.shape[:2]
        M = np.eye(3, dtype=np.float64)
        if self.affine:
            angle = rng.uniform(*self.rotation_range)
            tx = rng.uniform(*self.translate_range) * w
            ty = rng.uniform(*self.translate_range) * h
            A = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
            A[0, 2] += tx
            A[1, 2] += ty
            M = np.vstack([A, [0, 0, 1]]) @ M
        if self.perspective:
            mag = self.perspective_magnitude
            src = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
            dst = src + np.float32(
                [[rng.gauss(0, mag * w), rng.gauss(0, mag * h)] for _ in range(4)])
            P = cv2.getPerspectiveTransform(src, dst)
            M = P @ M
        img_w = cv2.warpPerspective(image, M, (w, h), flags=cv2.INTER_LINEAR,
                                    borderMode=cv2.BORDER_CONSTANT)
        mask_w = cv2.warpPerspective(mask, M, (w, h), flags=cv2.INTER_NEAREST,
                                     borderMode=cv2.BORDER_CONSTANT)
        if self.motion_blur and rng.random() < self.motion_blur_prob:
            k = rng.choice(self.motion_blur_kernel_sizes)
            kernel = np.zeros((k, k), np.float32)
            angle = rng.uniform(0, 180)
            c = k // 2
            dx, dy = np.cos(np.deg2rad(angle)), np.sin(np.deg2rad(angle))
            for i in range(k):
                x = int(round(c + (i - c) * dx))
                y = int(round(c + (i - c) * dy))
                if 0 <= x < k and 0 <= y < k:
                    kernel[y, x] = 1.0
            kernel /= max(kernel.sum(), 1)
            img_w = cv2.filter2D(img_w, -1, kernel)
        return img_w, mask_w


class RefExpDataset:
    """COCO-format referring detection (refexp.py), optionally as pseudo-video."""

    def __init__(self, img_folder: str, ann_file: str, num_frames: int = 1,
                 as_sequence: bool = False):
        self.img_folder = Path(img_folder)
        self.num_frames = num_frames
        self.as_sequence = as_sequence
        self.augmenter = ImageToSeqAugmenter()
        with open(ann_file) as f:
            coco = json.load(f)
        self.images = {im["id"]: im for im in coco["images"]}
        anns_by_img: Dict = {}
        for a in coco["annotations"]:
            anns_by_img.setdefault(a["image_id"], []).append(a)
        self.items = []
        for img_id, im in self.images.items():
            caption = im.get("caption", "")
            for a in anns_by_img.get(img_id, []):
                self.items.append((img_id, a, caption))

    def __len__(self):
        return len(self.items)

    def get_clip(self, idx: int, rng: random.Random) -> ClipRecord:
        img_id, ann, caption = self.items[idx]
        im_info = self.images[img_id]
        img = read_rgb(self.img_folder / im_info["file_name"])
        h, w = img.shape[:2]
        mask = polygons_to_mask(ann.get("segmentation", []), h, w)
        x, y, bw, bh = ann["bbox"]
        box = np.array([x, y, x + bw, y + bh], np.float32)

        if self.as_sequence and self.num_frames > 1:
            frames, masks = [img], [mask]
            for _ in range(self.num_frames - 1):
                fi, mi = self.augmenter(img, mask, rng)
                frames.append(fi)
                masks.append(mi)
            order = list(range(self.num_frames))
            rng.shuffle(order)  # random frame shuffle (refexp2seq.py:76-85)
            frames = [frames[i] for i in order]
            masks = [masks[i] for i in order]
            boxes, valids = [], []
            for m in masks:
                if m.any():
                    boxes.append(np.array(mask_bounding_box(m), np.float32))
                    valids.append(1)
                else:
                    boxes.append(np.zeros(4, np.float32))
                    valids.append(0)
            t = self.num_frames
            clip = Clip(
                frames=np.stack(frames).astype(np.float32),
                boxes=np.stack(boxes),
                masks=np.stack(masks).astype(np.float32),
                weak_masks=np.stack(masks).astype(np.float32),
                weights=np.stack(masks).astype(np.float32),
                valid=np.asarray(valids, np.int32),
                labels=np.zeros(t, np.int32),
                caption=" ".join(caption.lower().split()),
            )
        else:
            clip = Clip(
                frames=img[None].astype(np.float32),
                boxes=box[None],
                masks=mask[None],
                weak_masks=mask[None].copy(),
                weights=mask[None].copy(),
                valid=np.asarray([int(mask.any() or bw * bh > 0)], np.int32),
                labels=np.zeros(1, np.int32),
                caption=" ".join(caption.lower().split()),
            )
        return ClipRecord(clip, video=str(img_id))


class ConcatClipDataset:
    """Joint training over several datasets (datasets/concat_dataset.py:19-62)."""

    def __init__(self, datasets: List):
        self.datasets = datasets
        self.cum = np.cumsum([len(d) for d in datasets])

    def __len__(self):
        return int(self.cum[-1])

    def get_clip(self, idx: int, rng: random.Random) -> ClipRecord:
        di = int(np.searchsorted(self.cum, idx, side="right"))
        base = 0 if di == 0 else int(self.cum[di - 1])
        return self.datasets[di].get_clip(idx - base, rng)
