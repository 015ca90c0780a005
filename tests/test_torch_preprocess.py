"""The port's pseudo-label generator (``ocpg_tpu_torch/preprocess``) against
the JAX package's on the CPU.

* ``object_center`` and ``chamfer_distance`` equal cv2's
  ``minMaxLoc(distanceTransform(mask, DIST_L2, 5))`` exactly on random
  masks of many kinds: ties, single pixels, masks touching the border,
  full masks.
* The sim model: ResNet-50 weights from a replica's torchvision-layout body
  (``convert_resnet``, as ``--densecl`` loads them) in both packages;
  ``forward_point`` and ``forward_bbox`` on a 128 x 192 image within 1e-4
  of JAX's (float32 convolutions through 50 layers, summed in other
  orders), and the bbox mode's strided query grid (more than 256 in-box
  points) against JAX's on given features.
* The CRF, window and exact, binary and multi-label, within 1e-5 of JAX's.
* ``generate_for_frame`` (with and without the CRF) and the h5 files of
  ``run_ytvos`` and ``run_a2d`` on small trees within 1e-4 of JAX's,
  centres and object ids equal; ``main`` for both datasets with h5py
  blocked (the port's ``data/h5.py`` writes) read back by h5py as JAX's
  files; ``main --densecl`` on a replica ResNet-101 state dict writes what
  the converted weights give.
"""
import functools
import shutil
import sys

import numpy as np
import pytest
import torch

import cv2
import h5py
import flax.linen as fnn
import jax.numpy as jnp

from ocpg_tpu.models.backbone_resnet import build_resnet as jax_build_resnet
from ocpg_tpu.preprocess import dense_crf as jax_crf
from ocpg_tpu.preprocess import generate_anno as jax_gen
from ocpg_tpu.preprocess import sim_model as jax_sim
from ocpg_tpu.utils.torch_weights import convert_resnet as jax_convert_resnet

from ocpg_tpu_torch.preprocess import dense_crf, generate_anno, sim_model

from tests import torch_data_fixtures as fx
from tests.torch_threads import one_torch_thread  # noqa: F401

HEAT_ATOL = 1e-4
CRF_ATOL = 1e-5
H, W = 128, 192


# ------------------------------------------------------------ object centre --
def _masks(kind, rng):
    """Random masks of one kind, (H, W) uint8, sizes 1..60."""
    out = []
    for _ in range(25):
        h, w = (int(v) for v in rng.integers(1, 61, 2))
        m = np.zeros((h, w), np.uint8)
        yy, xx = np.mgrid[:h, :w]
        if kind == "noise":
            m = (rng.random((h, w)) > rng.uniform(0.1, 0.9)).astype(np.uint8)
        elif kind == "single_pixel":
            m[rng.integers(h), rng.integers(w)] = 1
        elif kind == "border":
            y0, x0 = rng.integers(0, h), rng.integers(0, w)
            m[y0:, x0:] = 1
            m[: rng.integers(1, h + 1), : rng.integers(1, w + 1)] = 1
        elif kind == "ellipse":
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            m = (((yy - cy) / max(h / 3, 1)) ** 2 + ((xx - cx) / max(w / 3, 1)) ** 2
                 <= 1).astype(np.uint8)
        elif kind == "ties":     # equal squares: the first in raster order wins
            s = int(rng.integers(1, 6))
            for y0, x0 in ((0, 0), (h // 2, 0), (0, w // 2), (h // 2, w // 2)):
                m[y0 + 1:y0 + 1 + s, x0 + 1:x0 + 1 + s] = 1
        elif kind == "full":
            m[:] = 1
        else:                    # "empty"
            pass
        out.append(m * np.uint8(rng.integers(1, 256)))
    return out


@pytest.mark.parametrize("kind", ["noise", "single_pixel", "border", "ellipse", "ties",
                                  "full", "empty"])
def test_object_center_equals_cv2(kind):
    rng = np.random.default_rng(["noise", "single_pixel", "border", "ellipse", "ties",
                                 "full", "empty"].index(kind))
    for m in _masks(kind, rng):
        dist = cv2.distanceTransform((m > 0).astype(np.uint8), cv2.DIST_L2, 5)
        got = generate_anno.chamfer_distance(m)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, dist)
        assert generate_anno.object_center(m) == tuple(cv2.minMaxLoc(dist)[3])
        if m.any():
            assert generate_anno.object_center(m) == jax_gen.object_center(m)


# ---------------------------------------------------------------- sim model --
def resnet_body_state_dict(layers, seed):
    """A torchvision-layout ResNet body (the replica's, as a DenseCL
    checkpoint holds it) with seeded FrozenBN statistics."""
    from tests.torch_replica import FrozenBN2d, ResNetBody

    torch.manual_seed(seed)
    body = ResNetBody(layers)
    g = torch.Generator().manual_seed(seed + 1)
    for mod in body.modules():
        if isinstance(mod, FrozenBN2d):
            n = mod.weight.numel()
            mod.weight.copy_(1 + 0.1 * torch.randn(n, generator=g))
            mod.bias.copy_(0.1 * torch.randn(n, generator=g))
            mod.running_mean.copy_(0.1 * torch.randn(n, generator=g))
            mod.running_var.copy_(0.5 + torch.rand(n, generator=g))
    return body.state_dict()


@pytest.fixture(scope="module")
def models():
    """(port sim model, JAX model, JAX variables), ResNet-50, same weights."""
    sd = resnet_body_state_dict((3, 4, 6, 3), seed=0)
    port = sim_model.init_sim_model("resnet50", device="cpu")
    sim_model.load_resnet_weights(port, sd)
    params, frozen = jax_convert_resnet(sd, (3, 4, 6, 3))
    return port, jax_build_resnet("resnet50", dilation=False), {"params": params,
                                                                "frozen": frozen}


def _image(rng, h=H, w=W):
    img = rng.standard_normal((1, h, w, 3)).astype(np.float32)
    return img, torch.from_numpy(img.transpose(0, 3, 1, 2).copy())


def test_forward_point_and_bbox_match_jax(models):
    port, jmodel, jparams = models
    img, t_img = _image(np.random.default_rng(1))
    for point in ((0.5, 0.5), (0.0, 0.0), (0.99, 0.3), (1.2, -0.1)):
        got = sim_model.forward_point(port, t_img, point)
        want = jax_sim.forward_point(jmodel, jparams, jnp.asarray(img), point)
        assert got.shape == want.shape == (4, 6)
        np.testing.assert_allclose(got, want, atol=HEAT_ATOL)
        assert abs(got.min()) < 1e-6                   # (a - min) / max: min maps to 0
    for box in ((10.0, 10.0, 150.0, 100.0), (0.0, 0.0, 191.0, 127.0), (100.0, 60.0, 101.0, 61.0),
                (180.0, 120.0, 191.0, 127.0)):
        got = sim_model.forward_bbox(port, t_img, box)
        want = jax_sim.forward_bbox(jmodel, jparams, jnp.asarray(img), box)
        np.testing.assert_allclose(got, want, atol=HEAT_ATOL, err_msg=str(box))


class _Given(fnn.Module):
    """A JAX 'backbone' whose layer4 is its input: the bbox mode on given
    features."""

    def __call__(self, x):
        return (x,)


@pytest.mark.parametrize("hw,box", [((18, 19), (0.0, 0.0, 18.0, 17.0)),
                                    ((40, 33), (2.0, 3.0, 31.0, 38.0)),
                                    ((17, 16), (5.0, 4.0, 5.0, 4.0))])
def test_bbox_strided_grid_matches_jax(hw, box):
    """More in-box points than MAX_QUERIES: the strided grid, the padded
    queries, the exclusive-end box mask, on features given to both."""
    rng = np.random.default_rng(hw[0])
    feat = np.abs(rng.standard_normal((1, *hw, 64))).astype(np.float32)
    want = jax_sim.forward_bbox(_Given(), {}, jnp.asarray(feat), box)
    keys = torch.from_numpy(feat.transpose(0, 3, 1, 2).copy())
    keys = keys / torch.linalg.vector_norm(keys, dim=1, keepdim=True)
    _, score = sim_model.bbox_scores(keys, box, hw)
    assert score.shape == (sim_model.MAX_QUERIES,) and float(score.min()) == -1.0
    np.testing.assert_allclose(sim_model.bbox_heat(keys, box, hw), want, atol=1e-5)


# ---------------------------------------------------------------------- CRF --
@pytest.mark.parametrize("exact", [False, True])
def test_dense_crf_matches_jax(exact):
    rng = np.random.default_rng(3)
    h, w = (20, 24) if exact else (40, 56)
    img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    prob = rng.random((h, w)).astype(np.float32)
    got = dense_crf.apply_dense_crf(img, prob, exact=exact)
    want = jax_crf.apply_dense_crf(img, prob, exact=exact)
    assert got.shape == (h, w)
    np.testing.assert_allclose(got, want, atol=CRF_ATOL)
    probs = rng.random((3, h, w)).astype(np.float32)
    if not exact:
        np.testing.assert_allclose(dense_crf.apply_dense_crf_multilabel(img, probs),
                                   jax_crf.apply_dense_crf_multilabel(img, probs), atol=CRF_ATOL)
    q = rng.random((2, h, w)).astype(np.float32)
    img_f = img.astype(np.float32)
    fn = "_potts_messages_dense" if exact else "_potts_messages"
    args = (img_f, q, 3.0, 50.0, 13.0) if exact else (img_f, q, 5, 3.0, 50.0, 13.0)
    for g, w_ in zip(getattr(dense_crf, fn)(*args), getattr(jax_crf, fn)(*args)):
        np.testing.assert_allclose(g, w_, atol=CRF_ATOL)


# ------------------------------------------------------------------ generator --
def _frame(rng):
    img = (rng.random((H, W, 3)) * 255).astype(np.uint8)
    masks = np.zeros((3, H, W), np.float32)
    masks[0, 8:60, 10:90] = 1
    masks[1, 70:125, 100:190] = 1          # touches the bottom border
    return img, masks                      # masks[2] empty


def _assert_generated(got, want):
    for g, w_, name in zip(got, want, ("heatBBox", "heatPoint")):
        assert g.dtype == np.float32 and g.shape == w_.shape, name
        np.testing.assert_allclose(g, w_, atol=HEAT_ATOL, err_msg=name)
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("use_crf", [False, True])
def test_generate_for_frame_matches_jax(use_crf, models):
    port, jmodel, jparams = models
    img, masks = _frame(np.random.default_rng(4))
    got = generate_anno.generate_for_frame(port, img, masks, use_crf)
    want = jax_gen.generate_for_frame(jmodel, jparams, img, masks, use_crf)
    assert got[0].shape == (3, H, W) and got[2].shape == (3, 2)
    assert not got[0][2].any() and not got[1][2].any() and tuple(got[2][2]) == (0, 0)
    _assert_generated(got, want)


def _h5(path):
    with h5py.File(path, "r") as f:
        return {k: np.asarray(f[k]) for k in f}


@pytest.mark.parametrize("dataset", ["ytvos", "a2d"])
def test_run_writes_the_h5_files_jax_writes(dataset, models, tmp_path):
    port, jmodel, jparams = models
    if dataset == "ytvos":
        src = fx.write_ytvos_tree(tmp_path / "src", n_frames=4, h=H, w=W, second_object=True)
        files = "train/AnnotationsWeakly/vid0/*.h5"
    else:
        src = fx.write_a2d_tree(tmp_path / "src", h=H, w=W)
        files = "text_annotations/a2d_annotation_with_instances/vidA/*.h5"
    shutil.copytree(src, tmp_path / "jax")
    shutil.move(src, tmp_path / "port")
    if dataset == "ytvos":
        generate_anno.run_ytvos(str(tmp_path / "port"), port, False)
        jax_gen.run_ytvos(str(tmp_path / "jax"), jmodel, jparams, False)
    else:
        generate_anno.run_a2d(str(tmp_path / "port"), port, False)
        jax_gen.run_a2d(str(tmp_path / "jax"), jmodel, jparams, False)
    paths = sorted((tmp_path / "port").glob(files))
    assert len(paths) == (4 if dataset == "ytvos" else 1)
    for p in paths:
        got, want = _h5(p), _h5(tmp_path / "jax" / p.relative_to(tmp_path / "port"))
        assert got.keys() == want.keys() and {"heatBBox", "heatPoint", "centerPoint"} <= set(got)
        for k in got:
            if k in ("heatBBox", "heatPoint"):
                np.testing.assert_allclose(got[k], want[k], atol=HEAT_ATOL, err_msg=k)
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("dataset", ["ytvos", "a2d"])
def test_main_without_h5py_writes_what_jax_writes(dataset, models, monkeypatch, tmp_path):
    """``main`` with h5py blocked (the port writes through its own h5
    module; the A2D files it rewrites were written by h5py): h5py reads the
    files back as the JAX generator's, on the same ResNet-50 weights."""
    _, jmodel, jparams = models
    torch.save({"state_dict": resnet_body_state_dict((3, 4, 6, 3), seed=0)},
               tmp_path / "r50.pth")
    if dataset == "ytvos":
        src = fx.write_ytvos_tree(tmp_path / "src", n_frames=3, h=H, w=W, second_object=True)
        files = "train/AnnotationsWeakly/vid0/*.h5"
    else:
        src = fx.write_a2d_tree(tmp_path / "src", h=H, w=W)
        files = "text_annotations/a2d_annotation_with_instances/vidA/*.h5"
    shutil.copytree(src, tmp_path / "jax")
    shutil.move(src, tmp_path / "port")
    getattr(jax_gen, f"run_{dataset}")(str(tmp_path / "jax"), jmodel, jparams, False)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "h5py", None)            # import h5py raises ImportError
        m.setattr(sim_model, "init_sim_model",
                  functools.partial(sim_model.init_sim_model, "resnet50"))
        generate_anno.main(["--dataset", dataset, "--root", str(tmp_path / "port"),
                            "--densecl", str(tmp_path / "r50.pth"), "--device", "cpu"])
    paths = sorted((tmp_path / "port").glob(files))
    assert len(paths) == (3 if dataset == "ytvos" else 1)
    for p in paths:
        got, want = _h5(p), _h5(tmp_path / "jax" / p.relative_to(tmp_path / "port"))
        assert got.keys() == want.keys() and {"heatBBox", "heatPoint", "centerPoint"} <= set(got)
        for k in got:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            if k in ("heatBBox", "heatPoint"):
                np.testing.assert_allclose(got[k], want[k], atol=HEAT_ATOL, err_msg=k)
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_main_densecl_loads_the_converted_weights(tmp_path):
    sd = resnet_body_state_dict((3, 4, 23, 3), seed=5)
    torch.save({"state_dict": sd}, tmp_path / "densecl.pth")
    tree = fx.write_ytvos_tree(tmp_path / "ytvos", n_frames=2, h=64, w=96)
    generate_anno.main(["--dataset", "ytvos", "--root", str(tree), "--densecl",
                        str(tmp_path / "densecl.pth"), "--device", "cpu"])
    model = sim_model.init_sim_model(device="cpu")
    seeded = {k: v.clone() for k, v in model.state_dict().items()}
    sim_model.load_resnet_weights(model, sd)
    assert not torch.equal(seeded["conv1.weight"], model.state_dict()["conv1.weight"])
    from ocpg_tpu_torch.data.imageio import read_palette, read_rgb

    for name in ("00000", "00001"):
        img = read_rgb(tree / "train/JPEGImages/vid0" / f"{name}.jpg")
        pal = read_palette(tree / "train/Annotations/vid0" / f"{name}.png")
        hb, hp, cp = generate_anno.generate_for_frame(model, img, (pal == 1)[None].astype(
            np.float32))
        got = _h5(tree / "train/AnnotationsWeakly/vid0" / f"{name}.h5")
        np.testing.assert_array_equal(got["heatBBox"], hb)
        np.testing.assert_array_equal(got["heatPoint"], hp)
        np.testing.assert_array_equal(got["centerPoint"], cp)
        np.testing.assert_array_equal(got["obj_ids"], [1])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            generate_anno.main(["--dataset", "ytvos", "--root", str(tree)])
