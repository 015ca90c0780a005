"""The one traffic generator: it reads a mix's parameters (a file under
``benchmark/traffic/``) and makes that mix's inputs from the run's seed,
on the card in a few large calls.

Two shapes of work, chosen by the file's ``"work"``:

* ``"clips"``: a pool of train batches on the compact wire (uint8 frames
  and masks, float16 heat maps) in pinned host memory, each of ``batch``
  clips of ``frames`` frames padded to ``canvas``.  Each clip's content
  takes a short side from ``scales`` and the long side of its ``aspect``,
  capped at ``max_size`` (the short side then follows the aspect); the rest
  of the canvas is padding with ``samples_mask`` set.  Each clip has one
  box moving right by 0.02 a frame, its mask, a Gaussian heat map and the
  heat map's weak mask, as ``ocpg_tpu_torch/data/synthetic.py`` makes them.
* ``"videos"``: a pool of videos, each with its frames (uint8, one size a
  video) and its expressions.  The frame counts, the expression counts and
  the sizes are a fixed multiset over the pool (evenly spaced quantiles of
  the stated ranges, the sizes in their stated shares); the seed pairs and
  orders them and draws the pixels and the tokens, so every seed asks for
  the same work in another order.

Text is ``text_len`` real tokens (uniform over the range, ``<s>`` first,
``</s>`` last, the rest drawn from the vocabulary) padded to ``text_pad``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch


def _quantiles(lo: int, hi: int, n: int) -> List[int]:
    """n evenly spaced quantiles of the integers lo..hi (a fixed uniform multiset)."""
    span = hi - lo + 1
    return [lo + int((i + 0.5) * span / n) for i in range(n)]


def _content_size(short: int, aspect: Tuple[int, int], max_size: int) -> Tuple[int, int]:
    """(h, w) of a landscape frame of ``aspect`` (w:h) with short side ``short``,
    its long side capped at ``max_size``."""
    aw, ah = aspect
    w = int(round(short * aw / ah))
    if w > max_size:
        w = max_size
        short = int(round(max_size * ah / aw))
    return short, w


def _text(rng: np.random.Generator, lo: int, hi: int, pad: int,
          vocab: int) -> Tuple[np.ndarray, np.ndarray]:
    n = int(rng.integers(lo, hi + 1))
    ids = np.ones(pad, np.int32)
    ids[:n] = rng.integers(4, vocab - 1, size=n)
    ids[0], ids[n - 1] = 0, 2
    mask = np.zeros(pad, np.int32)
    mask[:n] = 1
    return ids, mask


def _pinned(x: torch.Tensor) -> torch.Tensor:
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=x.is_cuda)
    host.copy_(x)
    return host


def make_clips(mix: Mapping, seed: int, device) -> List[Dict]:
    """The pool of train batches (see the module docstring)."""
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=device).manual_seed(int(seed))
    n, b, t = mix["pool"], mix["batch"], mix["frames"]
    ch, cw = mix["canvas"]
    aspect = tuple(mix["aspect"])
    clips = n * b
    sizes = [_content_size(int(s), aspect, mix["max_size"])
             for s in rng.choice(mix["scales"], size=clips)]
    # boxes: centre, size, drift per frame (normalised to the clip's content)
    cxy = rng.uniform(0.3, 0.7, (clips, 2))
    wh = rng.uniform(0.2, 0.4, (clips, 2))
    boxes = np.zeros((clips, t, 4), np.float32)
    for j in range(t):
        boxes[:, j, 0] = np.clip(cxy[:, 0] + 0.02 * j, 0.0, 1.0)
        boxes[:, j, 1] = cxy[:, 1]
        boxes[:, j, 2:] = wh
    hw = torch.tensor(sizes, dtype=torch.float32, device=device)            # (C, 2)
    yy = torch.arange(ch, device=device, dtype=torch.float32)[None, None, :, None]
    xx = torch.arange(cw, device=device, dtype=torch.float32)[None, None, None, :]
    bx = torch.from_numpy(boxes).to(device)                                  # (C, T, 4)
    h = hw[:, 0][:, None, None, None]
    w = hw[:, 1][:, None, None, None]
    cx, cy = bx[..., 0, None, None] * w, bx[..., 1, None, None] * h
    bw, bh = bx[..., 2, None, None] * w, bx[..., 3, None, None] * h
    content = (yy < h) & (xx < w)                                            # (C, 1, H, W)
    x0, x1 = (cx - bw / 2).floor(), (cx + bw / 2).floor()
    y0, y1 = (cy - bh / 2).floor(), (cy + bh / 2).floor()
    masks = ((xx >= x0.clamp(min=0)) & (xx < x1) & (yy >= y0.clamp(min=0)) & (yy < y1)
             & content)
    heat = torch.exp(-((xx - cx) ** 2 / (2 * (bw / 3 + 1) ** 2)
                       + (yy - cy) ** 2 / (2 * (bh / 3 + 1) ** 2))) * content
    frames = torch.randint(0, 256, (clips, t, ch, cw, 3), generator=g, device=device,
                           dtype=torch.uint8) * content[..., None]
    pad = ~content.expand(clips, t, ch, cw)
    texts = [_text(rng, *mix["text_len"], mix["text_pad"], mix["vocab"]) for _ in range(clips)]
    ids = np.stack([x[0] for x in texts])
    tmask = np.stack([x[1] for x in texts])
    hw_i = np.asarray(sizes, np.int32)
    pool = []
    for i in range(n):
        s = slice(i * b, (i + 1) * b)
        pool.append({
            "samples": _pinned(frames[s]),
            "samples_mask": _pinned(pad[s]),
            "text_ids": torch.from_numpy(ids[s]),
            "text_mask": torch.from_numpy(tmask[s]),
            "targets": {
                "labels": torch.zeros((b, t), dtype=torch.int32),
                "boxes": torch.from_numpy(boxes[s]),
                "valid": torch.ones((b, t), dtype=torch.int32),
                "masks": _pinned(masks[s].to(torch.uint8)),
                "weights": _pinned(heat[s].to(torch.float16)),
                "weak_masks": _pinned((heat[s] > 0.5).to(torch.uint8)),
                "size": torch.from_numpy(hw_i[s]),
            },
        })
    return pool


@dataclasses.dataclass
class Video:
    frames: np.ndarray                  # (t, h, w, 3) uint8
    texts: List[Tuple[np.ndarray, np.ndarray]]   # (ids, mask) per expression


def make_videos(mix: Mapping, seed: int, device) -> List[Video]:
    """The pool of videos (see the module docstring)."""
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=device).manual_seed(int(seed))
    n = mix["pool"]
    counts = _quantiles(*mix["frames"], n)
    exprs = _quantiles(*mix["expressions"], n)
    sizes: List[Sequence[int]] = []
    for size, share in mix["sizes"]:
        sizes += [tuple(size)] * int(round(share * n))
    if len(sizes) != n:
        raise ValueError(f"size shares give {len(sizes)} videos, not {n}")
    order = [rng.permutation(n) for _ in range(3)]
    pool = []
    for i in range(n):
        t = counts[order[0][i]]
        h, w = sizes[order[1][i]]
        frames = torch.randint(0, 256, (t, h, w, 3), generator=g, device=device,
                               dtype=torch.uint8).cpu().numpy()
        texts = [_text(rng, *mix["text_len"], mix["text_pad"], mix["vocab"])
                 for _ in range(exprs[order[2][i]])]
        pool.append(Video(frames, texts))
    return pool
