"""COCO-compatible run-length encoding: the port's copy of
``ocpg_tpu/evaluation/rle.py`` (pycocotools.mask without pycocotools).

Column-major (Fortran) RLE with the COCO LEB128-style string compression, so
outputs interoperate with COCO-format prediction JSONs.  Strings go through
the port's native codec (``native/io.py``, byte-identical) where the native
library builds, and through this module's Python codec elsewhere, as in the
JAX package.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _native_io():
    """The C++ codec (``native/ocpg_io.cpp``), byte-identical to this
    module's Python codec; None where the native library is unavailable
    (no g++, libjpeg or libpng)."""
    from ..native import io as nio

    return nio if nio.available() else None


def rle_encode(mask: np.ndarray) -> Dict:
    """Binary (H, W) mask -> {'size': [H, W], 'counts': str} COCO RLE."""
    h, w = mask.shape
    nio = _native_io()
    if nio is not None:
        return {"size": [int(h), int(w)],
                "counts": nio.rle_encode_str(np.asarray(mask, np.uint8))}
    flat = np.asfortranarray(mask > 0).reshape(-1, order="F").astype(np.uint8)
    # runs of equal value starting with 0s
    diffs = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    boundaries = np.concatenate([[0], diffs, [flat.size]])
    counts = np.diff(boundaries).tolist()
    if flat.size and flat[0] == 1:
        counts = [0] + counts
    return {"size": [int(h), int(w)], "counts": _compress(counts)}


def rle_decode(rle: Dict) -> np.ndarray:
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        nio = _native_io()
        if nio is not None:
            return nio.rle_decode_str(counts, int(h), int(w))
        counts = _decompress(counts)
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((h, w), order="F")


def _compress(counts: List[int]) -> str:
    """COCO's modified LEB128 with delta coding from the 3rd element."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c & 0x10)) or (x == -1 and (c & 0x10)))
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def _decompress(s) -> List[int]:
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


def rle_iou(a: Dict, b: Dict) -> float:
    ma = rle_decode(a).astype(bool)
    mb = rle_decode(b).astype(bool)
    union = (ma | mb).sum()
    if union == 0:
        return 0.0
    return float((ma & mb).sum() / union)
