"""ctypes bindings for the native ocpg_io decode library: counterpart of
``ocpg_tpu/native/io.py``.

The first call that needs the library compiles ``ocpg_io.cpp`` with the
system g++ into ``ocpg_tpu_torch/_build/`` (listed in ``.gitignore``), under
a name keyed by a hash of the source and the flags; importing this module
builds nothing.  It exposes

    decode_jpeg(data, denom=1)  -> (H, W, 3) uint8 RGB
    decode_png(data)            -> (H, W) uint8 palette indices or gray, or
                                   (H, W, 3) uint8 RGB
    png_is_palette(data)        -> bool
    rle_encode_str(mask)        -> COCO compressed-RLE counts string
    rle_decode_str(counts, h, w) -> (H, W) uint8 mask
    available()                 -> bool: the library built and loaded
    unavailable_reason()        -> why it did not, or None

ctypes releases the GIL around every foreign call, so the thread-pool loader
(``data/loader.py``) decodes on several cores at once.  A host without g++
or the libjpeg and libpng headers has no library: ``available()`` is False
and the decode functions raise.  ``data/imageio.py`` then decodes with PIL,
as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "ocpg_io.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17", "-Wall"]
_LIBS = ["-ljpeg", "-lpng"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_reason: Optional[str] = None

OK, EBAD, ESIZE, EARG = 0, -1, -2, -3

_u8p = ctypes.POINTER(ctypes.c_ubyte)
_i32p = ctypes.POINTER(ctypes.c_int)


def _build() -> str:
    """The built library's path; raises OSError or CalledProcessError."""
    with open(_SRC, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(_FLAGS + _LIBS).encode()).hexdigest()[:16]
    so_path = os.path.join(BUILD_DIR, f"ocpg_io_{key}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = so_path + f".tmp{os.getpid()}"
    subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp, *_LIBS], check=True,
                   capture_output=True, text=True, timeout=120)
    os.replace(tmp, so_path)  # atomic when several processes build at once
    return so_path


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _reason
    if _tried:
        return _lib
    with _lock:
        if _tried:
            return _lib
        try:
            lib = ctypes.CDLL(_build())
        except subprocess.CalledProcessError as e:
            errors = [ln for ln in (e.stderr or "").splitlines() if "error" in ln]
            _reason = "g++ failed: " + (errors[0] if errors else f"exit {e.returncode}")
            lib = None
        except (OSError, subprocess.SubprocessError) as e:
            _reason = f"{type(e).__name__}: {e}"
            lib = None
        if lib is not None:
            lib.ocpg_jpeg_info.argtypes = [_u8p, ctypes.c_ulong, ctypes.c_int, _i32p, _i32p]
            lib.ocpg_decode_jpeg.argtypes = [_u8p, ctypes.c_ulong, ctypes.c_int, _u8p,
                                             ctypes.c_ulong, _i32p, _i32p]
            lib.ocpg_png_info.argtypes = [_u8p, ctypes.c_ulong, _i32p, _i32p, _i32p]
            lib.ocpg_png_is_palette.argtypes = [_u8p, ctypes.c_ulong]
            lib.ocpg_decode_png.argtypes = [_u8p, ctypes.c_ulong, _u8p, ctypes.c_ulong,
                                            _i32p, _i32p, _i32p]
            lib.ocpg_rle_encode.argtypes = [_u8p, ctypes.c_long, ctypes.c_char_p,
                                            ctypes.c_long, ctypes.POINTER(ctypes.c_long)]
            lib.ocpg_rle_decode.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
                                            _u8p]
            for fn in (lib.ocpg_jpeg_info, lib.ocpg_decode_jpeg, lib.ocpg_png_info,
                       lib.ocpg_decode_png, lib.ocpg_png_is_palette, lib.ocpg_rle_encode,
                       lib.ocpg_rle_decode):
                fn.restype = ctypes.c_int
        _lib = lib
        _tried = True
        return _lib


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> Optional[str]:
    """Why the library did not build or load (None when it did)."""
    _load()
    return _reason


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native ocpg_io unavailable ({_reason})")
    return lib


def _as_u8p(data: bytes) -> Tuple[_u8p, int]:
    return ctypes.cast(ctypes.c_char_p(data), _u8p), len(data)


def decode_jpeg(data: bytes, denom: int = 1) -> np.ndarray:
    """Decode a JPEG byte string to (H, W, 3) uint8 RGB.

    ``denom`` in {1, 2, 4, 8} requests libjpeg's DCT-domain prescale (the
    image decoded at about 1/denom of full size); denom=1, the default
    everywhere in the data path, matches a full PIL decode."""
    lib = _lib_or_raise()
    buf, n = _as_u8p(data)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.ocpg_jpeg_info(buf, n, denom, ctypes.byref(h), ctypes.byref(w))
    if rc != OK:
        raise ValueError(f"bad JPEG stream (rc={rc})")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.ocpg_decode_jpeg(buf, n, denom, out.ctypes.data_as(_u8p), out.nbytes,
                              ctypes.byref(h), ctypes.byref(w))
    if rc != OK:
        raise ValueError(f"JPEG decode failed (rc={rc})")
    return out


def decode_png(data: bytes) -> np.ndarray:
    """Decode a PNG byte string: palette images give their palette indices
    as (H, W) uint8 (for DAVIS/YTVOS annotations the index is the object
    id), gray images (H, W) uint8, truecolor ones (H, W, 3) uint8 with any
    alpha dropped."""
    lib = _lib_or_raise()
    buf, n = _as_u8p(data)
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.ocpg_png_info(buf, n, ctypes.byref(h), ctypes.byref(w), ctypes.byref(c))
    if rc != OK:
        raise ValueError(f"bad PNG stream (rc={rc})")
    out = np.empty((h.value, w.value, c.value), np.uint8)
    rc = lib.ocpg_decode_png(buf, n, out.ctypes.data_as(_u8p), out.nbytes,
                             ctypes.byref(h), ctypes.byref(w), ctypes.byref(c))
    if rc != OK:
        raise ValueError(f"PNG decode failed (rc={rc})")
    return out[:, :, 0] if c.value == 1 else out


def png_is_palette(data: bytes) -> bool:
    """True if the PNG stream is palette-coded (``decode_png`` then gives
    the palette indices, not colors)."""
    lib = _lib_or_raise()
    buf, n = _as_u8p(data)
    rc = lib.ocpg_png_is_palette(buf, n)
    if rc < 0:
        raise ValueError(f"bad PNG stream (rc={rc})")
    return bool(rc)


def rle_encode_str(mask: np.ndarray) -> str:
    """C-order (H, W) uint8 mask -> COCO compressed-RLE counts string."""
    lib = _lib_or_raise()
    # the pixels go to the C side already in column-major order: numpy's
    # blocked transpose copy beats a strided column walk in C
    flat = np.asfortranarray(np.asarray(mask, np.uint8)).reshape(-1, order="F")
    cap = 7 * flat.size + 16
    out = np.empty(cap, np.uint8)
    out_len = ctypes.c_long()
    rc = lib.ocpg_rle_encode(flat.ctypes.data_as(_u8p), flat.size,
                             out.ctypes.data_as(ctypes.c_char_p), cap, ctypes.byref(out_len))
    if rc != OK:
        raise ValueError(f"RLE encode failed (rc={rc})")
    return out[:out_len.value].tobytes().decode("ascii")


def rle_decode_str(counts, h: int, w: int) -> np.ndarray:
    """COCO compressed-RLE counts string -> (H, W) uint8 mask (an F-order
    view, as the JAX package's codec returns)."""
    lib = _lib_or_raise()
    s = counts.encode("ascii") if isinstance(counts, str) else bytes(counts)
    flat = np.empty(h * w, np.uint8)
    rc = lib.ocpg_rle_decode(s, len(s), h * w, flat.ctypes.data_as(_u8p))
    if rc != OK:
        raise ValueError(f"RLE decode failed (rc={rc})")
    return flat.reshape((h, w), order="F")
