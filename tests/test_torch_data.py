"""The port's dataset readers, loader and device prefetch against the JAX
package's, on the CPU, on the on-disk trees of tests/torch_data_fixtures.py.

Tolerances: every reader's ClipRecord is exact (the same decodes and
arithmetic).  Loader batches: float32-wire frames within 1e-3 on the 0-255
scale (normalised: 1e-3 / 255 / the smallest std) and heatmaps within
1e-5, the INTER_LINEAR bounds of tests/test_torch_transforms.py; everything
else exact, the compact wire's uint8 frames and float16 heatmaps included
(measured: the resizes are bit-exact against cv2, so every batch is).
"""
import random
import sys

import numpy as np
import pytest
import torch

from ocpg_tpu.data import datasets as jds
from ocpg_tpu.data.loader import ClipLoader as JaxClipLoader
from ocpg_tpu.data.refer import REFER as JaxREFER
from ocpg_tpu.data.refexp import RefExpDataset as JaxRefExp
from ocpg_tpu_torch.data import datasets as pds
from ocpg_tpu_torch.data.loader import ClipLoader, decompress_batch
from ocpg_tpu_torch.data.refer import REFER
from ocpg_tpu_torch.data.refexp import RefExpDataset
from ocpg_tpu_torch.data.transforms import IMAGENET_STD
from ocpg_tpu_torch.engine.train import _to_device
from ocpg_tpu_torch.parallel import prefetch_to_mesh

from tests import torch_data_fixtures as fx

FRAME_ATOL = 1e-3
HEAT_ATOL = 1e-5
CLIP_FIELDS = ("frames", "boxes", "masks", "weak_masks", "weights", "valid", "labels")


@pytest.fixture(scope="module")
def ytvos_root(tmp_path_factory):
    return fx.write_ytvos_tree(tmp_path_factory.mktemp("ytvos"), n_frames=6,
                               second_object=True)


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    return fx.write_coco_tree(tmp_path_factory.mktemp("coco"))


def assert_records_equal(got, want):
    for f in CLIP_FIELDS:
        g, w = getattr(got.clip, f), getattr(want.clip, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert got.clip.caption == want.clip.caption
    assert got.valid_indices == want.valid_indices
    assert (got.video, list(got.frame_names), got.exp_id) == (
        want.video, list(want.frame_names), want.exp_id)


def assert_datasets_equal(port, jax, seeds=(0, 1)):
    assert len(port) == len(jax) > 0
    for idx in range(len(port)):
        for seed in seeds:
            pr, jr = random.Random(seed * 100 + idx), random.Random(seed * 100 + idx)
            assert_records_equal(port.get_clip(idx, pr), jax.get_clip(idx, jr))
            assert pr.getstate() == jr.getstate()


@pytest.mark.parametrize("supervision", ["box", "point"])
def test_ytvos_reader_matches_jax(ytvos_root, supervision):
    port = pds.YTVOSDataset(str(ytvos_root), num_frames=3, supervision=supervision)
    assert_datasets_equal(port, jds.YTVOSDataset(str(ytvos_root), 3, supervision))
    # object 2 leaves the video halfway: its late clips have invalid frames
    valid = [port.get_clip(i, random.Random(i)).clip.valid.min() for i in range(len(port))]
    assert 0 in valid and 1 in valid


def test_davis_reader_matches_jax(ytvos_root):
    assert_datasets_equal(pds.DAVISDataset(str(ytvos_root), num_frames=4),
                          jds.DAVISDataset(str(ytvos_root), num_frames=4))


@pytest.mark.parametrize("split,supervision", [("train", "box"), ("train", "point"),
                                               ("val", "box")])
def test_a2d_reader_matches_jax(tmp_path, split, supervision):
    root = fx.write_a2d_tree(tmp_path, split=split)
    port = pds.A2DSentencesDataset(str(root), 3, supervision, split)
    assert_datasets_equal(port, jds.A2DSentencesDataset(str(root), 3, supervision, split),
                          seeds=range(4))
    assert port.get_clip(0, random.Random(0)).valid_indices is not None


def records_of(ds, seeds):
    """Every clip of a dataset under each seed, and the generator's state after."""
    out = []
    for idx in range(len(ds)):
        for seed in seeds:
            rng = random.Random(seed * 100 + idx)
            out.append((ds.get_clip(idx, rng), rng.getstate()))
    return out


def assert_reads_without_h5py(monkeypatch, port_dataset, jax, seeds):
    """The JAX reader's clips (read with h5py), then the port's with h5py
    blocked (h5py itself imports lazily, so the JAX reader reads first)."""
    want = records_of(jax, seeds)
    monkeypatch.setitem(sys.modules, "h5py", None)      # import h5py raises ImportError
    got = records_of(port_dataset(), seeds)
    assert len(got) == len(want) > 0
    for (g, gs), (w, ws) in zip(got, want):
        assert_records_equal(g, w)
        assert gs == ws


@pytest.mark.parametrize("supervision", ["box", "point"])
def test_ytvos_reader_without_h5py_matches_jax(ytvos_root, supervision, monkeypatch):
    """The port reads the h5py-written heatmaps with its own h5 module."""
    assert_reads_without_h5py(
        monkeypatch, lambda: pds.YTVOSDataset(str(ytvos_root), 3, supervision),
        jds.YTVOSDataset(str(ytvos_root), 3, supervision), (0, 1))


@pytest.mark.parametrize("split,supervision", [("train", "box"), ("train", "point"),
                                               ("val", "box")])
def test_a2d_reader_without_h5py_matches_jax(tmp_path, split, supervision, monkeypatch):
    root = fx.write_a2d_tree(tmp_path, split=split)
    assert_reads_without_h5py(
        monkeypatch, lambda: pds.A2DSentencesDataset(str(root), 3, supervision, split),
        jds.A2DSentencesDataset(str(root), 3, supervision, split), range(4))


def test_jhmdb_reader_matches_jax(tmp_path):
    root = fx.write_jhmdb_tree(tmp_path)
    assert_datasets_equal(pds.JHMDBSentencesDataset(str(root), 3),
                          jds.JHMDBSentencesDataset(str(root), 3))


@pytest.mark.parametrize("as_sequence", [False, True])
def test_refexp_dataset_matches_jax(coco_root, as_sequence):
    args = (str(coco_root / "train2014"), str(coco_root / "instances_refcoco_train.json"))
    assert_datasets_equal(RefExpDataset(*args, num_frames=3, as_sequence=as_sequence),
                          JaxRefExp(*args, num_frames=3, as_sequence=as_sequence),
                          seeds=range(3))


def test_joint_registries_match_jax(ytvos_root, coco_root):
    for name, root, kw in (("joint", str(ytvos_root), {"coco_path": str(coco_root)}),
                           ("joint_coco", None, {"coco_path": str(coco_root)}),
                           ("ytvos_joint_davis", str(ytvos_root),
                            {"davis_path": str(ytvos_root)})):
        port = pds.build_dataset(name, root, "train", 3, "full", **kw)
        jax = jds.build_dataset(name, root, "train", 3, "full", **kw)
        assert len(port) == len(jax) and len(port) > 0, name
        for idx in sorted({0, 1, 2, len(port) // 2, len(port) - 1}):
            assert_records_equal(port.get_clip(idx, random.Random(idx)),
                                 jax.get_clip(idx, random.Random(idx)))
    with pytest.raises(ValueError):
        pds.build_dataset("joint", str(ytvos_root), "train", 3, "full")
    with pytest.raises(ValueError):
        pds.build_dataset("nope", str(ytvos_root), "train", 3)


def test_refer_matches_jax(tmp_path):
    root = fx.write_refer_tree(tmp_path)
    port, jax = REFER(str(root), "refcoco", "unc"), JaxREFER(str(root), "refcoco", "unc")
    for split in ("", "train", "test", "testA", "val"):
        assert port.getRefIds(split=split) == jax.getRefIds(split=split)
    assert port.getRefIds(image_ids=[100], cat_ids=[1]) == jax.getRefIds(image_ids=[100],
                                                                          cat_ids=[1])
    assert port.getAnnIds(ref_ids=[2]) == jax.getAnnIds(ref_ids=[2])
    assert sorted(port.getImgIds(ref_ids=[1, 3])) == sorted(jax.getImgIds(ref_ids=[1, 3]))
    assert port.loadCats(1) == jax.loadCats(1) and port.getRefBox(3) == jax.getRefBox(3)
    assert port.sentToTokens == jax.sentToTokens
    for ref_id in (1, 2, 3):
        got, want = port.getMask(port.Refs[ref_id]), jax.getMask(jax.Refs[ref_id])
        np.testing.assert_array_equal(got["mask"], want["mask"])
        assert got["area"] == want["area"] > 0


def assert_batches_equal(got, want, path="batch"):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_batches_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_batches_equal(g, w, f"{path}/{i}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        atol = 0.0
        if want.dtype == np.float32 and path.endswith("/samples"):
            atol = FRAME_ATOL / 255 / float(IMAGENET_STD.min())
        elif want.dtype == np.float32 and path.endswith("/weights"):
            atol = HEAT_ATOL
        np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=path)
    else:
        assert got == want, path


@pytest.mark.parametrize("train,num_workers,compact,epoch", [
    (True, 1, False, 0), (True, 3, True, 1), (False, 1, True, 0), (False, 3, False, 1)])
def test_loader_epochs_match_jax(ytvos_root, train, num_workers, compact, epoch):
    """Whole epochs, train and eval, 1 and 3 workers, both wires: train
    drops the remainder, eval pads the tail batch (real_count) and carries
    the ragged native-size masks; the canvas is small enough that the
    fit-to-canvas downscale runs.  The JAX loader's threads are scheduled
    apart from the port's, so equality also shows the reorder buffer."""
    kw = dict(batch_size=5, canvas=(256, 320), train=train, seed=5,
              num_workers=num_workers, text_vocab=2048, compact=compact)
    port = ClipLoader(pds.YTVOSDataset(str(ytvos_root), num_frames=2), **kw)
    jax = JaxClipLoader(jds.YTVOSDataset(str(ytvos_root), num_frames=2), **kw)
    got, want = list(port.epoch(epoch)), list(jax.epoch(epoch))
    assert len(got) == len(want) == (2 if train else 3)     # 12 clips
    for g, w in zip(got, want):
        assert_batches_equal(g, w)
    if not train:
        assert got[-1]["real_count"] == 2 and "orig_masks" in got[-1]
    assert got[0]["samples"].dtype == (np.uint8 if compact else np.float32)


def test_loader_abandoned_epoch_stops_its_workers(ytvos_root):
    ds = pds.YTVOSDataset(str(ytvos_root), num_frames=2)
    loader = ClipLoader(ds, batch_size=1, canvas=(256, 320), num_workers=3, text_vocab=2048)
    it = loader.epoch(0)
    next(it)
    it.close()           # sets stop: the bounded put lets blocked workers leave
    import threading
    import time

    deadline = time.time() + 10
    while time.time() < deadline and any(t.daemon and t.name.startswith("Thread")
                                         and t.is_alive() for t in threading.enumerate()
                                         if t is not threading.main_thread()):
        time.sleep(0.05)
    assert not [t for t in threading.enumerate() if t.daemon and t.name.startswith("Thread")
                and t.is_alive()]


def test_loader_needs_the_model_vocab(ytvos_root):
    with pytest.raises(ValueError):
        ClipLoader(pds.YTVOSDataset(str(ytvos_root)), batch_size=1)


def test_prefetch_on_the_cpu_yields_the_batches_in_order(ytvos_root):
    ds = pds.YTVOSDataset(str(ytvos_root), num_frames=2)
    loader = ClipLoader(ds, batch_size=2, canvas=(256, 320), train=False, num_workers=2,
                        text_vocab=2048, compact=True)
    want = list(loader.epoch(0))
    got = list(prefetch_to_mesh(iter(want), "cpu"))
    assert len(got) == len(want)
    for (host, dev), w in zip(got, want):
        assert host is w
        assert isinstance(dev["samples"], torch.Tensor) and dev["samples"].device.type == "cpu"
        assert_batches_equal({k: v for k, v in _numpy(dev).items()}, w)
    # the step takes the device batch as it is (no copy of a tensor already there)
    assert _to_device(got[0][1], torch.device("cpu"))["samples"] is got[0][1]["samples"]
    # the compact wire expands on the device to the float32 pipeline's batch
    out = decompress_batch(got[0][1])
    assert out["samples"].dtype == torch.float32 and out["targets"]["weights"].dtype == torch.float32


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return tree


def test_rle_segmentations_decode_without_the_native_library(monkeypatch):
    """polygons_to_mask's compressed-RLE branch: the native decoder, and the
    module's own codec where the library is not built, equal JAX's."""
    from ocpg_tpu.data.refexp import polygons_to_mask as jax_polygons_to_mask
    from ocpg_tpu.evaluation.rle import rle_encode
    from ocpg_tpu_torch.data import refexp
    from ocpg_tpu_torch.native import io as nio

    rng = np.random.default_rng(4)
    mask = (rng.random((37, 52)) > 0.6).astype(np.uint8)
    segs = [rle_encode(mask), {"size": [37, 52], "counts": [3, 5, 100, 7, 1811]},
            [[2, 2, 30, 4, 20, 30, 3, 25]]]
    for segm in segs:
        want = jax_polygons_to_mask(segm, 37, 52)
        np.testing.assert_array_equal(refexp.polygons_to_mask(segm, 37, 52), want)
        monkeypatch.setattr(nio, "_lib", None)
        np.testing.assert_array_equal(refexp.polygons_to_mask(segm, 37, 52), want)
        monkeypatch.undo()
    np.testing.assert_array_equal(refexp.polygons_to_mask(segs[0], 37, 52), mask)
