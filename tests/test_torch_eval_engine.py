"""The port's eval engine (``ocpg_tpu_torch/engine/evaluate.py``) against
the JAX package's on the same loader batches, with the JAX weights carried
across (``load_jax_params``), at the TINY widths of
tests/test_e2e_evaluate.py on a 64 x 80 canvas:

* ``evaluate_a2d`` with the host and the device postprocess, on an A2D val
  tree (mp4 and h5 annotations) and a JHMDB tree, batches of 2 with a
  padded tail, and ``evaluate_refexp_loop`` on a RefCOCO tree: every
  prediction's score within 1e-4 of JAX's, its binary mask equal to JAX's
  except at pixels whose resized logit is within 1e-3 of 0, the ground
  truths' RLE identical, and the metric dicts within 1e-6;
* the device postprocess's embedded resize matrices against JAX's traced
  ones within 1e-6 (tests/test_engine.py's cases), its bit packing against
  ``np.packbits``, and the no-GPU default refusing.

The JAX runs are cached at module scope.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ocpg_tpu.config import OCPGConfig as JaxConfig
from ocpg_tpu.engine import evaluate as jax_evaluate
from ocpg_tpu.models import build_model as jax_build_model

from ocpg_tpu_torch.config import OCPGConfig
from ocpg_tpu_torch.data.datasets import build_dataset
from ocpg_tpu_torch.data.loader import ClipLoader
from ocpg_tpu_torch.data.refexp import RefExpDataset
from ocpg_tpu_torch.engine import evaluate
from ocpg_tpu_torch.evaluation.rle import rle_decode
from ocpg_tpu_torch.models.build import build_model
from ocpg_tpu_torch.models.text_encoder import SimpleTokenizer
from ocpg_tpu_torch.ops.image import bilinear_resize
from ocpg_tpu_torch.utils.weights import load_jax_params

from tests import torch_data_fixtures as fx
from tests.test_e2e_evaluate import TINY_CFG
from tests.test_torch_model import random_variables
from tests.torch_threads import one_torch_thread  # noqa: F401

CANVAS = (64, 80)
SCORE_ATOL = 1e-4
LOGIT_BAND = 1e-3
METRIC_ATOL = 1e-6


def jax_config(dataset_file):
    return JaxConfig(backbone="resnet50", dataset_file=dataset_file, num_frames=3,
                     msda_impl="xla", **TINY_CFG)


def port_model(dataset_file, weights):
    jcfg = jax_config(dataset_file)
    names = {f.name for f in dataclasses.fields(OCPGConfig)}
    model = build_model(OCPGConfig(**{k: getattr(jcfg, k) for k in names}), device="cpu")
    load_jax_params(model, weights)
    return model


class Batches:
    """A loader over fixed batches (the evaluate functions read epoch 0)."""

    def __init__(self, batches):
        self.batches = batches

    def epoch(self, _):
        yield from self.batches


@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    """Two batches of 2 of each tree (the tail padded, real_count 1)."""
    root = tmp_path_factory.mktemp("eval_trees")
    tok = SimpleTokenizer(vocab_size=TINY_CFG["text_vocab"])
    a2d = fx.write_a2d_tree(root / "a2d", split="val")
    jhmdb = fx.write_jhmdb_tree(root / "jhmdb")
    (root / "coco").mkdir()
    coco = fx.write_coco_tree(root / "coco")
    sets = {
        "a2d": build_dataset("a2d", str(a2d), "val", 3),
        "jhmdb": build_dataset("jhmdb", str(jhmdb), "val", 3),
        "refcoco": RefExpDataset(str(coco / "train2014"),
                                 str(coco / "instances_refcoco_train.json")),
    }
    out = {}
    for name, ds in sets.items():
        class Repeat:                    # 3 samples: a full batch and a padded tail
            def __len__(self):
                return 3

            def get_clip(self, idx, rng, ds=ds):
                return ds.get_clip(idx % len(ds), rng)

        loader = ClipLoader(Repeat(), 2, tokenizer=tok, train=False, canvas=CANVAS,
                            compact=True, num_workers=1)
        out[name] = list(loader.epoch(0))
        assert out[name][-1]["real_count"] == 1
    return out


@pytest.fixture(scope="module")
def weights():
    jmodel, *_ = jax_build_model(jax_config("a2d"))
    return random_variables(jmodel, seed=3)


def _capture(module, name, store):
    fn = getattr(module, name)

    def wrapper(*args):
        store.setdefault(name, []).append(args)
        return fn(*args)
    return wrapper


@pytest.fixture(scope="module")
def jax_runs(batches, weights):
    """{(tree, postprocess): (metrics, captured metric inputs)} of the JAX
    evaluate functions on one CPU device."""
    mesh = Mesh(np.asarray(jax.devices("cpu")[:1]), ("data",))
    params = jax.tree_util.tree_map(jnp.asarray, weights)
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        for tree in ("a2d", "jhmdb", "refcoco"):
            jmodel, *_ = jax_build_model(jax_config(tree))
            for post in (("host", "device") if tree != "refcoco" else ("loop",)):
                store = {}
                for name in ("_metrics", "_refexp_metrics"):
                    mp.setattr(jax_evaluate, name, _capture(jax_evaluate, name, store))
                if tree == "refcoco":
                    metrics = jax_evaluate.evaluate_refexp_loop(
                        jmodel, params, Batches(batches[tree]), mesh=mesh)
                else:
                    metrics = jax_evaluate.evaluate_a2d(
                        jmodel, params, Batches(batches[tree]), mesh=mesh, postprocess=post)
                mp.undo()
                runs[(tree, post)] = (metrics, store)
    return runs


def _port_run(tree, post, batches, weights):
    model = port_model(tree, weights)
    store = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in ("_metrics", "_refexp_metrics"):
            mp.setattr(evaluate, name, _capture(evaluate, name, store))
        if tree == "refcoco":
            metrics = evaluate.evaluate_refexp_loop(model, Batches(batches[tree]),
                                                    device="cpu")
        else:
            metrics = evaluate.evaluate_a2d(model, Batches(batches[tree]),
                                            postprocess=post, device="cpu")
    return model, metrics, store


def _resized_logits(model, batches, valid_indices):
    """Per real sample, (Q, H, W) mask logits at the original size."""
    out = []
    for batch in batches:
        with torch.no_grad():
            res = evaluate._forward(model, batch, torch.device("cpu"), valid_indices)
        masks = res["pred_masks"][:, 0]
        sizes = np.asarray(batch["targets"]["size"])
        orig = np.asarray(batch["targets"]["orig_size"])
        for i in range(int(batch.get("real_count", len(sizes)))):
            h, w = sizes[i]
            out.append(bilinear_resize(masks[i:i + 1, :, :h, :w], tuple(orig[i]))[0].numpy())
    return out


def _assert_predictions(got, want, logits, q):
    assert len(got) == len(want) == q * len(logits)
    flips = 0
    for k, (g, w) in enumerate(zip(got, want)):
        assert g["image_id"] == w["image_id"]
        assert abs(g["score"] - w["score"]) <= SCORE_ATOL, (k, g["score"], w["score"])
        gm, wm = rle_decode(g["rle"]).astype(bool), rle_decode(w["rle"]).astype(bool)
        band = np.abs(logits[k // q][k % q]) < LOGIT_BAND
        assert not ((gm != wm) & ~band).any(), f"prediction {k}: masks differ off the band"
        flips += int((gm != wm).sum())
    return flips


def _assert_metrics(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= METRIC_ATOL, (k, got[k], want[k])
        assert np.isfinite(got[k])


@pytest.mark.parametrize("tree", ["a2d", "jhmdb"])
@pytest.mark.parametrize("post", ["host", "device"])
def test_evaluate_a2d_matches_jax(tree, post, batches, weights, jax_runs):
    model, metrics, store = _port_run(tree, post, batches, weights)
    want_metrics, want_store = jax_runs[(tree, post)]
    (preds, gts), = store["_metrics"]
    (want_preds, want_gts), = want_store["_metrics"]
    assert gts == want_gts
    logits = _resized_logits(model, batches[tree], valid_indices=True)
    _assert_predictions(preds, want_preds, logits, TINY_CFG["num_queries"])
    _assert_metrics(metrics, want_metrics)
    assert set(metrics) == {"mAP 0.5:0.95", "AP50", "AP75", "overall_iou", "mean_iou",
                            "P@0.5", "P@0.6", "P@0.7", "P@0.8", "P@0.9"}


def test_evaluate_refexp_loop_matches_jax(batches, weights, jax_runs):
    model, metrics, store = _port_run("refcoco", "loop", batches, weights)
    want_metrics, want_store = jax_runs[("refcoco", "loop")]
    (preds, gts), = store["_metrics"]
    (want_preds, want_gts), = want_store["_metrics"]
    assert gts == want_gts
    logits = _resized_logits(model, batches["refcoco"], valid_indices=False)
    _assert_predictions(preds, want_preds, logits, TINY_CFG["num_queries"])
    (box_preds, box_gts), = store["_refexp_metrics"]
    (want_box_preds, want_box_gts), = want_store["_refexp_metrics"]
    for g, w in zip(box_gts, want_box_gts):
        np.testing.assert_allclose(g["box"], w["box"], rtol=1e-6)
    for g, w in zip(box_preds, want_box_preds):
        np.testing.assert_allclose(g["scores"], w["scores"], atol=SCORE_ATOL)
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=0.2)   # pixels
    _assert_metrics(metrics, want_metrics)
    for prefix in ("bbox_P@1", "segm_mAP 0.5:0.95", "coco_bbox_AP", "coco_bbox_AR@100"):
        assert prefix in metrics


def test_device_postprocess_matrices_and_packing():
    for src, dst, vs, vd in ((80, 128, 80, 100), (64, 64, 48, 37), (96, 192, 50, 192),
                             (64, 128, 64, 128)):
        got = evaluate.embedded_resize_matrix(src, dst, vs, vd)
        want = np.asarray(jax_evaluate._resize_matrix_traced(
            src, dst, jnp.asarray(vs), jnp.asarray(vd)))
        np.testing.assert_allclose(got, want, atol=1e-6)
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((2, 1, 3, 40, 56)).astype(np.float32))
    sizes = np.asarray([[40, 56], [30, 44]])
    orig = np.asarray([[50, 70], [30, 44]])
    bucket = evaluate.output_bucket(orig)
    assert bucket == (64, 128)
    packed = evaluate.device_postprocess(logits, sizes, orig, bucket).numpy()
    assert packed.shape == (2, 3, 64, 16) and packed.dtype == np.uint8
    for i in range(2):
        (h, w), (oh, ow) = sizes[i], orig[i]
        want = bilinear_resize(logits[i, 0, :, :h, :w][None], (oh, ow))[0].numpy() > 0
        full = np.zeros((3, 64, 128), bool)
        full[:, :oh, :ow] = want
        np.testing.assert_array_equal(packed[i], np.packbits(full, axis=-1))


def test_evaluate_needs_a_gpu_unless_asked_for_the_cpu(batches, weights):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU refusal cannot be shown here")
    model = port_model("a2d", weights)
    for call in (lambda: evaluate.evaluate_a2d(model, Batches(batches["a2d"])),
                 lambda: evaluate.evaluate_refexp_loop(model, Batches(batches["a2d"]))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
