"""The port's native decode library and image readers against the JAX
package's and PIL, on the CPU.

Exact: JPEG and PNG decodes (the same libjpeg and libpng as the JAX
package's build), the RLE strings and masks (against the JAX package's
pure-Python codec, its oracle), and ``read_rgb`` / ``read_palette``
against the JAX readers and PIL.  The format is told by magic bytes.
"""
import io as bio
import os

import numpy as np
import pytest
from PIL import Image

from ocpg_tpu.data import imageio as jax_imageio
from ocpg_tpu.evaluation import rle as jax_rle
from ocpg_tpu.native import io as jax_nio
from ocpg_tpu_torch.data import imageio
from ocpg_tpu_torch.native import io as nio


@pytest.fixture(scope="module", autouse=True)
def native_built():
    """The JAX tests of this library skip without the toolchain; the port's
    decode tests need the library built here."""
    if not jax_nio.available():
        pytest.skip("the libjpeg/libpng toolchain is not on this host")
    assert nio.available(), nio.unavailable_reason()


def _jpeg(img, **kw):
    b = bio.BytesIO()
    Image.fromarray(img).save(b, "JPEG", **kw)
    return b.getvalue()


def _png(img, mode=None, palette=None, **kw):
    pim = Image.fromarray(img, mode=mode) if mode else Image.fromarray(img)
    if palette is not None:
        pim.putpalette(palette)
    b = bio.BytesIO()
    pim.save(b, "PNG", **kw)
    return b.getvalue()


def test_library_builds_into_the_port_build_dir():
    built = [f for f in os.listdir(nio.BUILD_DIR) if f.startswith("ocpg_io_") and f.endswith(".so")]
    assert built and nio.unavailable_reason() is None
    assert os.path.dirname(nio.BUILD_DIR) == os.path.dirname(os.path.dirname(nio.__file__))


@pytest.mark.parametrize("kind", ["baseline", "progressive", "gray", "prescale"])
def test_jpeg_decode_matches_jax_and_pil(kind):
    rng = np.random.default_rng(0)
    if kind == "gray":
        data = _jpeg(rng.integers(0, 256, (50, 70), np.uint8), quality=95)
    else:
        data = _jpeg(rng.integers(0, 256, (101, 75, 3), np.uint8),
                     progressive=kind == "progressive")
    denom = 4 if kind == "prescale" else 1
    got = nio.decode_jpeg(data, denom=denom)
    np.testing.assert_array_equal(got, jax_nio.decode_jpeg(data, denom=denom))
    if denom == 1:
        pil = np.asarray(Image.open(bio.BytesIO(data)).convert("RGB"))
        assert got.shape == pil.shape and np.abs(got.astype(int) - pil).max() <= 1
    else:
        assert got.shape == (26, 19, 3)


def test_png_decodes_match_jax():
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 7, (97, 133), np.uint8)
    cases = {
        "palette": _png(idx, "P", list(rng.integers(0, 256, 21))),
        "palette 1-bit": _png(idx % 2, "P", [0, 0, 0, 255, 255, 255], bits=1),
        "gray": _png(rng.integers(0, 256, (33, 47), np.uint8), "L"),
        "rgb": _png(rng.integers(0, 256, (21, 34, 3), np.uint8)),
        "rgba": _png(rng.integers(0, 256, (15, 18, 4), np.uint8), "RGBA"),
    }
    for name, data in cases.items():
        got = nio.decode_png(data)
        np.testing.assert_array_equal(got, jax_nio.decode_png(data), err_msg=name)
        assert nio.png_is_palette(data) == jax_nio.png_is_palette(data) == name.startswith(
            "palette"), name
    np.testing.assert_array_equal(nio.decode_png(cases["palette"]), idx)


def test_bad_streams_raise():
    for fn in (nio.decode_jpeg, nio.decode_png, nio.png_is_palette):
        with pytest.raises(ValueError):
            fn(b"not an image at all")


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (64, 80), (480, 854)])
def test_rle_matches_the_jax_codec(shape):
    rng = np.random.default_rng(shape[0])
    for mask in (rng.random(shape) > 0.5, np.zeros(shape, bool), np.ones(shape, bool)):
        want = jax_rle.rle_encode(mask)
        got = nio.rle_encode_str(mask.astype(np.uint8))
        assert got == want["counts"] == jax_nio.rle_encode_str(mask.astype(np.uint8))
        np.testing.assert_array_equal(nio.rle_decode_str(got, *shape), mask.astype(np.uint8))


def test_readers_match_jax_and_pil(tmp_path):
    """read_rgb / read_palette on JPEG, truecolor, gray and palette PNGs;
    the format comes from the magic bytes (a PNG named .jpg, a JPEG named
    .png); palette PNGs in read_rgb and truecolor PNGs in read_palette go
    through PIL, as in the JAX package."""
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 256, (40, 56, 3), np.uint8)
    idx = rng.integers(0, 5, (40, 56), np.uint8)
    files = {
        "frame.jpg": _jpeg(rgb, quality=90),
        "jpeg_named.png": _jpeg(rgb, quality=80),
        "png_named.jpg": _png(rgb),
        "gray.png": _png(idx * 50, "L"),
        "palette.png": _png(idx, "P", list(rng.integers(0, 256, 15))),
    }
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
        p = tmp_path / name
        got = imageio.read_rgb(p)
        np.testing.assert_array_equal(got, jax_imageio.read_rgb(p), err_msg=name)
        np.testing.assert_array_equal(got, np.asarray(Image.open(p).convert("RGB")),
                                      err_msg=name)
        if name.endswith(".png") and not name.startswith("jpeg"):
            pal = imageio.read_palette(p)
            np.testing.assert_array_equal(pal, jax_imageio.read_palette(p), err_msg=name)
    np.testing.assert_array_equal(imageio.read_palette(tmp_path / "palette.png"), idx)
    np.testing.assert_array_equal(imageio.read_palette(tmp_path / "png_named.jpg"),
                                  np.asarray(Image.open(tmp_path / "png_named.jpg").convert("P")))
    assert imageio.decoder() == "native"


def test_readers_without_the_library_decode_with_pil(tmp_path, monkeypatch):
    """A host where the library cannot be built decodes every file with
    PIL, as the JAX package does; decoder() says so and why."""
    rng = np.random.default_rng(3)
    (tmp_path / "a.jpg").write_bytes(_jpeg(rng.integers(0, 256, (24, 40, 3), np.uint8)))
    (tmp_path / "b.png").write_bytes(_png(rng.integers(0, 4, (24, 40), np.uint8), "P",
                                          [0, 0, 0, 9, 9, 9, 80, 80, 80, 255, 0, 0]))
    want = [imageio.read_rgb(tmp_path / "a.jpg"), imageio.read_palette(tmp_path / "b.png")]
    monkeypatch.setattr(nio, "_lib", None)
    monkeypatch.setattr(nio, "_reason", "g++ failed: jpeglib.h: No such file or directory")
    assert not nio.available()
    assert imageio.decoder().startswith("PIL (native ocpg_io unavailable: g++ failed")
    with pytest.raises(RuntimeError, match="unavailable"):
        nio.decode_jpeg(b"\xff\xd8")
    np.testing.assert_array_equal(imageio.read_rgb(tmp_path / "a.jpg"), want[0])
    np.testing.assert_array_equal(imageio.read_palette(tmp_path / "b.png"), want[1])
