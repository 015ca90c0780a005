"""Image decode for the data path: counterpart of ``ocpg_tpu/data/imageio.py``.

``read_rgb(path)`` and ``read_palette(path)`` equal
``np.asarray(Image.open(path).convert("RGB"|"P"))`` on the formats the
datasets hold (JPEG frames, palette-PNG annotation masks).  The format is
told by the file's magic bytes, never its extension.  The native library
(``native/io.py``, libjpeg and libpng through ctypes, the GIL released)
decodes JPEG and PNG.  PIL takes what it does not cover, exactly where the
JAX package hands over to PIL: palette PNGs in ``read_rgb`` (their native
decode gives indices, which mean colors only through the palette),
truecolor PNGs in ``read_palette`` (``convert("P")`` quantizes), other
formats, streams the native decoder rejects, and every file on a host
where the native library cannot be built (no g++, libjpeg or libpng
headers), as in the JAX package.  ``decoder()`` says which holds here.
PIL is imported only when a file needs it.
"""

from __future__ import annotations

import os
from typing import Union

import numpy as np

from ..native import io as _native

JPEG_MAGIC = b"\xff\xd8"
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def decoder() -> str:
    """"native" when the native library is available on this host, else
    "PIL (native ocpg_io unavailable: <reason>)"."""
    if _native.available():
        return "native"
    return f"PIL (native ocpg_io unavailable: {_native.unavailable_reason()})"


def _read_bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _pil_open(path):
    from PIL import Image

    return Image.open(path)


def read_rgb(path: Union[str, "os.PathLike"]) -> np.ndarray:
    """(H, W, 3) uint8 RGB: ``Image.open(path).convert("RGB")``."""
    if _native.available():
        data = _read_bytes(path)
        try:
            if data[:2] == JPEG_MAGIC:
                return _native.decode_jpeg(data)
            if data[:8] == PNG_MAGIC and not _native.png_is_palette(data):
                out = _native.decode_png(data)
                if out.ndim == 3:
                    return out
                return np.repeat(out[:, :, None], 3, axis=2)  # gray -> RGB
        except ValueError:
            pass  # a stream the native decoder rejects: PIL raises its own error
    return np.asarray(_pil_open(path).convert("RGB"))


def read_palette(path: Union[str, "os.PathLike"]) -> np.ndarray:
    """(H, W) uint8 palette indices: ``Image.open(path).convert("P")`` for
    palette and gray PNGs (annotation masks: index == object id)."""
    if _native.available():
        data = _read_bytes(path)
        try:
            if data[:8] == PNG_MAGIC:
                out = _native.decode_png(data)
                if out.ndim == 2:   # palette indices or gray
                    return out
        except ValueError:
            pass
    return np.asarray(_pil_open(path).convert("P"))
