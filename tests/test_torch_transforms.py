"""The port's clip transforms (numpy, no cv2) against the JAX package's
(cv2), on the CPU.

Tolerances, on the same inputs:

* nearest resizes (masks, weak masks), flips, crops, boxes, ``valid``,
  captions and the uint8 HSV round trip: exact;
* ``INTER_LINEAR`` frames: <= 1e-3 absolute on the 0-255 scale; heatmaps
  <= 1e-5 (measured: 0 against cv2 5.0, whose fused multiply-adds the port
  emulates);
* normalised frames: the frames' bound over 255 x the smallest std.

Every random draw comes from one ``random.Random``: after each transform
both generators are in the same state.
"""
import copy
import random

import cv2
import numpy as np
import pytest

from ocpg_tpu.data import transforms as jt
from ocpg_tpu_torch.data import transforms as pt

FRAME_ATOL = 1e-3
HEAT_ATOL = 1e-5
NORM_ATOL = FRAME_ATOL / 255 / float(pt.IMAGENET_STD.min())


def make_clip(seed, h, w, t=3, caption="the dog on the left turns right"):
    rng = np.random.default_rng(seed)
    masks = np.zeros((t, h, w), np.float32)
    boxes = np.zeros((t, 4), np.float32)
    for i in range(t):
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        y1, x1 = y0 + rng.integers(2, h // 2), x0 + rng.integers(2, w // 2)
        masks[i, y0:y1, x0:x1] = 1
        boxes[i] = (x0, y0, x1 - 1, y1 - 1)
    return pt.Clip(
        frames=np.floor(rng.random((t, h, w, 3)) * 256).astype(np.float32),
        boxes=boxes, masks=masks,
        weak_masks=(rng.random((t, h, w)) > 0.7).astype(np.float32),
        weights=rng.random((t, h, w)).astype(np.float32),
        valid=np.ones(t, np.int32), labels=np.zeros(t, np.int32), caption=caption)


def as_jax(clip):
    return jt.Clip(**{f: copy.deepcopy(getattr(clip, f)) for f in
                      ("frames", "boxes", "masks", "weak_masks", "weights", "valid",
                       "labels", "caption")})


def assert_clips_match(got, want, frame_atol=FRAME_ATOL):
    assert got.frames.shape == want.frames.shape and got.frames.dtype == want.frames.dtype
    np.testing.assert_allclose(got.frames, want.frames, atol=frame_atol, rtol=0)
    np.testing.assert_allclose(got.weights, want.weights, atol=HEAT_ATOL, rtol=0)
    for k in ("boxes", "masks", "weak_masks", "valid", "labels"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
        assert getattr(got, k).dtype == getattr(want, k).dtype, k
    assert got.caption == want.caption


@pytest.mark.parametrize("src,dst", [
    ((64, 80), (100, 125)),     # upscale
    ((64, 80), (48, 60)),       # downscale
    ((63, 81), (31, 47)),       # odd sizes
    ((64, 80), (32, 40)),       # exact 2x (cv2 4.x: INTER_AREA, the same mean)
    ((37, 53), (512, 640)),     # large upscale
    ((720, 1280), (288, 512)),  # a YTVOS frame to the smallest train scale
    ((400, 711), (512, 910)),
    ((64, 80), (64, 33)),       # one axis only
])
def test_resize_clip_matches_cv2(src, dst):
    clip = make_clip(0, *src, t=2)
    want = jt._resize_clip(as_jax(clip), dst)
    got = pt._resize_clip(clip, dst)
    assert got.size == dst
    assert_clips_match(got, want)


def test_resize_linear_refuses_other_dtypes():
    with pytest.raises(TypeError):
        pt.resize_linear(np.zeros((1, 4, 4), np.uint8), (2, 3))


def test_hsv_round_trip_matches_cv2_exactly():
    # every RGB color with an even red, and every HSV triple with H in
    # [0, 180) and an even V, in rows of 4096 pixels (cv2's 32-pixel blocks)
    r, g, b = np.meshgrid(np.arange(0, 256, 2), np.arange(256), np.arange(256), indexing="ij")
    rgb = np.stack([r, g, b], -1).astype(np.uint8).reshape(-1, 4096, 3)
    np.testing.assert_array_equal(pt.rgb_to_hsv_u8(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(0, 256, 2), indexing="ij")
    hsv = np.stack([h, s, v], -1).astype(np.uint8).reshape(-1, 4096, 3)
    np.testing.assert_array_equal(pt.hsv_to_rgb_u8(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


@pytest.mark.parametrize("width", [17, 33, 626])
def test_hsv_to_rgb_row_tails_match_cv2(width):
    """A row's last width mod 32 pixels take cv2's one-pixel path."""
    rng = np.random.default_rng(width)
    hsv = np.stack([rng.integers(0, 180, (40, width)), rng.integers(0, 256, (40, width)),
                    rng.integers(0, 256, (40, width))], -1).astype(np.uint8)
    np.testing.assert_array_equal(pt.hsv_to_rgb_u8(hsv[None])[0],
                                  cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


@pytest.mark.parametrize("seed", range(6))
def test_photometric_distort_matches_jax(seed):
    clip = make_clip(seed, 24, 32)
    jr, pr = random.Random(seed), random.Random(seed)
    want = jt.photometric_distort(as_jax(clip), rng=jr)
    got = pt.photometric_distort(clip, rng=pr)
    assert pr.getstate() == jr.getstate()
    np.testing.assert_array_equal(got.frames, want.frames)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("photometric", [False, True])
def test_train_transform_matches_jax(seed, photometric):
    """Both RandomSelect branches (resize; resize, crop, resize), the flip
    with its caption swap, compact and normalised frames."""
    clip = make_clip(seed, 90, 160)
    normalize_images = seed % 2 == 0
    jr, pr = random.Random(seed), random.Random(seed)
    want = jt.train_transform(as_jax(clip), rng=jr, photometric=photometric,
                              normalize_images=normalize_images)
    got = pt.train_transform(clip, rng=pr, photometric=photometric,
                             normalize_images=normalize_images)
    assert pr.getstate() == jr.getstate()
    assert_clips_match(got, want, NORM_ATOL if normalize_images else FRAME_ATOL)


@pytest.mark.parametrize("src", [(64, 80), (90, 160), (720, 1280), (300, 200)])
def test_val_transform_matches_jax(src):
    clip = make_clip(1, *src, t=2)
    want = jt.val_transform(as_jax(clip))
    assert_clips_match(pt.val_transform(clip), want, NORM_ATOL)


def test_hflip_caption_swap_and_boxes():
    clip = make_clip(2, 8, 8, t=1, caption="the left dog right here")
    out = pt.random_hflip(clip, p=1.1)
    assert out.caption == "the right dog left here"
    want = jt.random_hflip(as_jax(make_clip(2, 8, 8, t=1, caption="the left dog right here")),
                           p=1.1)
    assert_clips_match(out, want)


@pytest.mark.parametrize("compact", [False, True])
def test_pad_to_canvas_matches_jax(compact):
    clip = pt.normalize(make_clip(3, 40, 56), images=not compact)
    want = jt.pad_to_canvas(as_jax(clip), (64, 96), compact=compact)
    got = pt.pad_to_canvas(clip, (64, 96), compact=compact)
    assert got["caption"] == want["caption"]
    for k in ("samples", "samples_mask"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    for k, v in want["targets"].items():
        assert got["targets"][k].dtype == v.dtype, k
        np.testing.assert_array_equal(got["targets"][k], v, err_msg=k)
    assert pt.canvas_for() == jt.canvas_for() == (512, 640)
    assert pt.canvas_for(600, 64) == jt.canvas_for(600, 64)
    with pytest.raises(ValueError):
        pt.pad_to_canvas(clip, (32, 96))
