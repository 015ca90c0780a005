"""The batch wire: counterpart of ``ocpg_tpu/data/loader.py``'s
``decompress_batch`` (the loader itself is not ported yet).

A compact batch carries un-normalised uint8 RGB frames, binary uint8 masks
and float16 heatmaps, about a third of the bytes of a float32 batch.  The
train step moves it to the device as it is and expands it there.
"""

from __future__ import annotations

from typing import Dict

import torch

from .transforms import IMAGENET_MEAN, IMAGENET_STD


def decompress_batch(batch: Dict) -> Dict:
    """The compact wire's inverse, on the batch's own device: uint8 RGB
    becomes ImageNet-normalised float32 with the canvas padding
    (``samples_mask``) re-zeroed in normalised space, as the reference pads
    zeros after normalising; non-float32 masks, weights and weak_masks become
    float32.  A float32 batch comes back unchanged."""
    b = dict(batch)
    t = dict(b["targets"])
    s = b["samples"]
    if s.dtype == torch.uint8:
        mean = torch.from_numpy(IMAGENET_MEAN).to(s.device)
        std = torch.from_numpy(IMAGENET_STD).to(s.device)
        x = (s.float() / 255.0 - mean) / std
        b["samples"] = torch.where(b["samples_mask"][..., None], 0.0, x)
    for k in ("masks", "weights", "weak_masks"):
        if k in t and t[k].dtype != torch.float32:
            t[k] = t[k].float()
    b["targets"] = t
    return b
