"""The port's metric modules (``ocpg_tpu_torch/evaluation``), its
visualisation helpers and its uint8 resize against the JAX package's on the
same seeded inputs: RLE strings identical (native and Python codecs), the
A2D, RefExp and COCO metric dicts equal to 1e-12, DAVIS J and F bit-exact
against the JAX module's cv2 dilation (empty, full and border-touching
masks, with and without void) and the disk dilation itself against cv2's,
``evaluate_davis`` on a written tree equal, and ``resize_linear_u8`` equal
to cv2's uint8 INTER_LINEAR."""
import numpy as np
import pytest
from PIL import Image

from ocpg_tpu.evaluation import a2d_metrics as jax_a2d
from ocpg_tpu.evaluation import coco_eval as jax_coco
from ocpg_tpu.evaluation import davis_eval as jax_davis_eval
from ocpg_tpu.evaluation import davis_metrics as jax_davis
from ocpg_tpu.evaluation import refexp_metrics as jax_refexp
from ocpg_tpu.evaluation import rle as jax_rle
from ocpg_tpu.utils import visualize as jax_vis

from ocpg_tpu_torch.evaluation import a2d_metrics, coco_eval, davis_eval, davis_metrics
from ocpg_tpu_torch.evaluation import refexp_metrics, rle
from ocpg_tpu_torch.utils import visualize

EXACT = 1e-12


def _masks(rng, n, h, w):
    """Random blobs plus the edge cases: empty, full, one pixel, a border
    band, and a mask starting with a 1."""
    out = [(rng.random((h, w)) > p).astype(np.uint8) for p in rng.uniform(0.2, 0.9, n)]
    border = np.zeros((h, w), np.uint8)
    border[0], border[:, -1] = 1, 1
    dot = np.zeros((h, w), np.uint8)
    dot[h // 2, w // 3] = 1
    first = np.zeros((h, w), np.uint8)
    first[0, 0] = 1
    return out + [np.zeros((h, w), np.uint8), np.ones((h, w), np.uint8), dot, border, first]


@pytest.mark.parametrize("codec", ["native", "python"])
def test_rle_strings_and_round_trips_match_jax(codec, monkeypatch):
    if codec == "python":
        monkeypatch.setattr(rle, "_native_io", lambda: None)
    elif rle._native_io() is None:
        pytest.skip("the native library does not build on this host")
    rng = np.random.default_rng(0)
    for m in _masks(rng, 6, 37, 53):
        got, want = rle.rle_encode(m), jax_rle.rle_encode(m)
        assert got == want
        np.testing.assert_array_equal(rle.rle_decode(got), m)
        np.testing.assert_array_equal(rle.rle_decode(want), jax_rle.rle_decode(want))
        assert rle.rle_iou(got, got) == jax_rle.rle_iou(want, want)
    # uncompressed counts decode the same way
    counts = {"size": [3, 4], "counts": [2, 3, 4, 3]}
    np.testing.assert_array_equal(rle.rle_decode(counts), jax_rle.rle_decode(counts))


def _segm_inputs(rng, n_img=5, q=4, h=24, w=30):
    preds, gts = [], []
    for i in range(n_img):
        gt = np.zeros((h, w), np.uint8)
        y, x = rng.integers(0, h // 2), rng.integers(0, w // 2)
        gt[y:y + h // 2, x:x + w // 2] = 1
        gts.append({"image_id": f"img_{i}", "rle": jax_rle.rle_encode(gt)})
        for _ in range(q):
            m = gt.copy() if rng.random() < 0.5 else (rng.random((h, w)) > 0.6).astype(np.uint8)
            m ^= (rng.random((h, w)) > 0.95).astype(np.uint8)
            preds.append({"image_id": f"img_{i}", "score": float(rng.random()),
                          "rle": jax_rle.rle_encode(m)})
    return preds, gts


def _assert_dicts(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= EXACT, (k, got[k], want[k])


def test_a2d_metrics_match_jax():
    rng = np.random.default_rng(1)
    for n_img in (1, 6):
        preds, gts = _segm_inputs(rng, n_img)
        _assert_dicts(a2d_metrics.evaluate_a2d(preds, gts), jax_a2d.evaluate_a2d(preds, gts))
    _assert_dicts(a2d_metrics.evaluate_a2d([], gts), jax_a2d.evaluate_a2d([], gts))


def _boxes(rng, n, size=100.0):
    xy = rng.uniform(0, size * 0.7, (n, 2))
    wh = rng.uniform(2, size * 0.5, (n, 2))
    return np.concatenate([xy, xy + wh], 1)


def test_refexp_metrics_match_jax():
    rng = np.random.default_rng(2)
    preds = [{"image_id": i, "boxes": _boxes(rng, 10), "scores": rng.random(10)}
             for i in range(7)]
    gts = [{"image_id": i, "box": _boxes(rng, 1)[0]} for i in range(6)]
    for ks in ((1, 5, 10), (2,)):
        _assert_dicts(refexp_metrics.evaluate_refexp(preds, gts, ks),
                      jax_refexp.evaluate_refexp(preds, gts, ks))


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_coco_evaluator_matches_jax(iou_type):
    rng = np.random.default_rng(3)
    if iou_type == "bbox":
        dts, gts = [], []
        for i in range(6):
            for b in _boxes(rng, int(rng.integers(1, 4)), size=300.0):
                gts.append({"image_id": i, "box": b, "iscrowd": int(rng.random() < 0.15)})
            for b in _boxes(rng, 12, size=300.0):
                dts.append({"image_id": i, "box": b, "score": float(rng.random())})
    else:
        dts, gts = _segm_inputs(rng, n_img=4, q=5, h=40, w=48)
    _assert_dicts(coco_eval.CocoEvaluatorLite(iou_type).evaluate(dts, gts),
                  jax_coco.CocoEvaluatorLite(iou_type).evaluate(dts, gts))


def test_davis_measures_match_jax_bit_exactly():
    rng = np.random.default_rng(4)
    h, w = 60, 90
    masks = _masks(rng, 5, h, w)
    void = (rng.random((h, w)) > 0.9).astype(np.uint8)
    for a in masks:
        for b in masks[::2]:
            for v in (None, void):
                assert davis_metrics.db_eval_iou(a, b, v) == jax_davis.db_eval_iou(a, b, v)
                for th in (0.008, 0.05, 3):
                    assert (davis_metrics.f_measure(b, a, v, th)
                            == jax_davis.f_measure(b, a, v, th))
    stack_a, stack_b = np.stack(masks[:4]), np.stack(masks[4:8])
    voids = np.stack([void] * 4)
    np.testing.assert_array_equal(davis_metrics.db_eval_boundary(stack_a, stack_b, voids),
                                  jax_davis.db_eval_boundary(stack_a, stack_b, voids))
    np.testing.assert_array_equal(davis_metrics._seg2bmap(masks[0]),
                                  jax_davis._seg2bmap(masks[0]))


def _write_davis(root, rng, videos=("va", "vb"), t=6, h=40, w=56):
    palette = [0, 0, 0, 200, 10, 10, 10, 200, 10] + [255] * (256 * 3 - 9)
    for split in ("Annotations", "results"):
        for v in videos:
            (root / split / v).mkdir(parents=True)
    for v in videos:
        for i in range(t):
            gt = np.zeros((h, w), np.uint8)
            gt[5 + i:20 + i, 4:30] = 1
            gt[22:38, 30 + i:50] = 2
            gt[0:3, :5] = 255                       # void
            res = gt.copy()
            res[res == 255] = 0
            res[(rng.random((h, w)) > 0.93)] = int(rng.integers(0, 3))
            for split, arr in (("Annotations", gt), ("results", res)):
                img = Image.fromarray(arr, mode="P")
                img.putpalette(palette)
                img.save(root / split / v / f"{i:05d}.png")
    (root / "ImageSets" / "2017").mkdir(parents=True)
    (root / "ImageSets" / "2017" / "val.txt").write_text("\n".join(videos) + "\n")


@pytest.mark.parametrize("task", ["unsupervised", "semi-supervised"])
def test_evaluate_davis_matches_jax(tmp_path, task):
    _write_davis(tmp_path, np.random.default_rng(5))
    got = davis_eval.evaluate_davis(str(tmp_path), str(tmp_path / "results"), "val", task)
    want = jax_davis_eval.evaluate_davis(str(tmp_path), str(tmp_path / "results"), "val",
                                         task)
    assert got == want
    assert davis_eval.global_summary(got) == jax_davis_eval.global_summary(want)
    x = np.random.default_rng(6).random(300)
    assert davis_eval.db_statistics(x) == jax_davis_eval.db_statistics(x)


def test_visualize_matches_jax(tmp_path):
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
    mask = rng.random((30, 40))
    np.testing.assert_array_equal(visualize.vis_add_mask(img, mask, (10, 200, 30)),
                                  jax_vis.vis_add_mask(img, mask, (10, 200, 30)))
    assert visualize.COLORS == jax_vis.COLORS
    for mod, name in ((visualize, "port.png"), (jax_vis, "jax.png")):
        mod.save_overlay(tmp_path / name, img, mask, (0, 255, 0), (0.25, 0.5))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port.png")),
                                  np.asarray(Image.open(tmp_path / "jax.png")))


def test_resize_linear_u8_matches_cv2():
    """The inference CLIs' frame resize (JAX: cv2.resize on uint8)."""
    import cv2

    from ocpg_tpu_torch.data.transforms import resize_linear_u8

    rng = np.random.default_rng(8)
    for h, w, oh, ow in ((720, 1280, 360, 640), (480, 854, 360, 640), (240, 320, 360, 480),
                         (48, 64, 192, 256), (100, 130, 61, 77), (37, 50, 360, 487),
                         (5, 7, 11, 3), (48, 64, 48, 64)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        np.testing.assert_array_equal(
            resize_linear_u8(img, (oh, ow)),
            cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR), err_msg=str((h, w)))
    with pytest.raises(TypeError):
        resize_linear_u8(img.astype(np.float32), (4, 4))


def test_disk_dilation_matches_cv2():
    """The F measure's dilation against cv2.dilate (the JAX module's), at
    the DAVIS 720p radius and at edges: radii past the map, half-integer
    radii (even kernels, anchored at k // 2), thin maps."""
    import cv2

    rng = np.random.default_rng(10)
    for h, w in ((720, 1280), (13, 7), (1, 5), (3, 2)):
        for r in (1, 2.5, 12, 30):
            corners = rng.random((h, w)) > 0.995
            corners[0, 0] = corners[-1, -1] = True
            dot = np.zeros((h, w), bool)
            dot[h // 2, w // 3] = True
            for b in (corners, dot, np.zeros((h, w), bool)):
                kernel = davis_metrics._disk(r)
                np.testing.assert_array_equal(davis_metrics._dilate_disk(b, kernel),
                                              cv2.dilate(b.astype(np.uint8), kernel) > 0)
