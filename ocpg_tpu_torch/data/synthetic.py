"""Synthetic clip batches with the target schema of the real datasets.

A copy of ``ocpg_tpu/data/synthetic.py`` (numpy only), so that the port's
tests and ``chip_smoke.py`` make the same inputs as the JAX package from the
same seed.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def synthetic_batch(
    rng: np.random.Generator,
    batch: int = 1,
    frames: int = 3,
    height: int = 320,
    width: int = 576,
    text_len: int = 16,
    with_valid_indices: bool = False,
    vocab_size: int = 50265,
    visible_objects: bool = False,
) -> Dict[str, np.ndarray]:
    """Returns a host batch dict matching make_train_step's expectations.

    visible_objects=True blends each clip's object heatmap into the image so
    the mask is learnable from pixels (noise-only images force the model to
    memorize masks through the text key — a pathological overfit task used
    nowhere in the real datasets).  Convergence tests use this; benches and
    parity tests keep pure-noise inputs (identical compute).
    """
    b, t, h, w = batch, frames, height, width
    samples = rng.standard_normal((b, t, h, w, 3)).astype(np.float32)
    samples_mask = np.zeros((b, t, h, w), dtype=bool)

    # a moving box object per clip
    boxes = np.zeros((b, t, 4), np.float32)
    masks = np.zeros((b, t, h, w), np.float32)
    heat = np.zeros((b, t, h, w), np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(b):
        cx, cy = rng.uniform(0.3, 0.7, 2)
        bw, bh = rng.uniform(0.2, 0.4, 2)
        for j in range(t):
            cxj = np.clip(cx + 0.02 * j, 0.0, 1.0)
            boxes[i, j] = (cxj, cy, bw, bh)
            x0, x1 = int((cxj - bw / 2) * w), int((cxj + bw / 2) * w)
            y0, y1 = int((cy - bh / 2) * h), int((cy + bh / 2) * h)
            masks[i, j, max(y0, 0):y1, max(x0, 0):x1] = 1.0
            heat[i, j] = np.exp(
                -(((xx - cxj * w) ** 2) / (2 * (bw * w / 3 + 1) ** 2)
                  + ((yy - cy * h) ** 2) / (2 * (bh * h / 3 + 1) ** 2))
            )

    if visible_objects:
        # dim the noise and paint the object in: pixels carry the mask signal
        samples = (0.3 * samples + 2.0 * heat[..., None]).astype(np.float32)

    text_ids = rng.integers(4, vocab_size - 1, size=(b, text_len)).astype(np.int32)
    text_ids[:, 0] = 0
    text_mask = np.ones((b, text_len), np.int32)

    targets = {
        "labels": np.zeros((b, t), np.int32),
        "boxes": boxes,
        "valid": np.ones((b, t), np.int32),
        "masks": masks,
        "weights": heat.astype(np.float32),
        "weak_masks": (heat > 0.5).astype(np.float32),
        "size": np.tile(np.array([[h, w]], np.int32), (b, 1)),
    }
    out = {
        "samples": samples,
        "samples_mask": samples_mask,
        "text_ids": text_ids,
        "text_mask": text_mask,
        "targets": targets,
    }
    if with_valid_indices:
        out["valid_indices"] = rng.integers(0, t, size=(b,)).astype(np.int32)
    return out
