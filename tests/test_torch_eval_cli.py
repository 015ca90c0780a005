"""The port's evaluate, eval_davis and pretrain CLIs on the CPU (``--device
cpu``) against the JAX CLIs on the same trees with the same initial
weights, at the TINY widths of tests/test_e2e_evaluate.py on a 64 x 80
canvas.  The JAX CLIs are driven through ``sys.argv`` on one CPU device
(``jax.devices`` and ``jax.device_count`` narrowed to it, so their batches
are the port's) with their model's ``init`` jitted; their initial weights
are captured from the run and carried into the port (a port checkpoint for
``--checkpoint``).

* evaluate, A2D (three val videos, batches of 2 with a padded tail) and
  JHMDB: the metric dicts within 1e-6.
* eval_davis: the same summary and the same CSV files.
* pretrain, one epoch of RefCOCO (T = 1, the steps deterministic) from
  carried JAX weights: its first batch equal to the JAX pretrain CLI's loader's, the
  first step's losses and gradient norm within the tolerances of
  tests/test_torch_train_model.py of JAX's on that batch (the JAX CLI
  itself spends minutes compiling its train step on a CPU; ``evaluate_refexp_loop``
  is held against JAX in tests/test_torch_eval_engine.py), the logged
  ``refcoco_{bbox,segm,coco_bbox}_*`` keys finite, the checkpoint written;
  the eval model holds the trained weights when it runs, and a fresh eval
  model loaded from the checkpoint reproduces the logged metrics.
* A reference ``.pth`` checkpoint and ``--tokenizer_path``: evaluate's
  metrics equal the JAX CLI's with the same flags, pretrain's first batch
  the JAX loader's with the same tokenizer; without a GPU the default
  device raises.

The JAX runs are cached at module scope.
"""
import contextlib
import io
import json
import shutil
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from ocpg_tpu.cli import eval_davis as jax_eval_davis_cli
from ocpg_tpu.cli import evaluate as jax_evaluate_cli

from ocpg_tpu_torch.cli import eval_davis as eval_davis_cli
from ocpg_tpu_torch.cli import evaluate as evaluate_cli
from ocpg_tpu_torch.cli import pretrain as pretrain_cli
from ocpg_tpu_torch.config import OCPGConfig, apply_config_overrides
from ocpg_tpu_torch.engine import evaluate as port_evaluate
from ocpg_tpu_torch.engine.checkpoint import CheckpointManager
from ocpg_tpu_torch.models import build as port_build
from ocpg_tpu_torch.utils.weights import load_jax_params

from tests import torch_data_fixtures as fx
from tests.test_e2e_evaluate import TINY_CFG
from tests.test_torch_evaluation import _write_davis
from tests.torch_threads import one_torch_thread  # noqa: F401

H, W = 64, 80
CANVAS = ["--canvas", str(H), str(W)]
METRIC_ATOL = 1e-6
LOSS_RTOL = 1e-5


@contextlib.contextmanager
def jax_cli(argv):
    """Run a JAX CLI as `python -m ... argv` on one CPU device, its model's
    ``init`` jitted (eager, it takes a minute on a CPU); yields the patcher (to
    capture more) and the captured stdout."""
    import ocpg_tpu.models as jax_models

    cpu0 = jax.devices("cpu")[0]
    build = jax_models.build_model

    def build_jitted_init(cfg):
        built = build(cfg)
        object.__setattr__(built[0], "init",
                           jax.jit(built[0].init, static_argnames=("train",)))
        return built

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["cli"] + argv)
        mp.setattr(jax, "devices", lambda *a, **k: [cpu0])
        mp.setattr(jax, "device_count", lambda *a, **k: 1)
        mp.setattr(jax_models, "build_model", build_jitted_init)
        with contextlib.redirect_stdout(out):
            yield mp, out


def capture_arg(mp, module, name, index, store):
    """Wrap module.name to keep its positional argument ``index``."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        store.append(args[index])
        return fn(*args, **kwargs)
    mp.setattr(module, name, wrapper)


def port_checkpoint(variables, cfg, directory):
    """The JAX variables in a port checkpoint (``--checkpoint``)."""
    model = port_build.build_model(cfg, device="cpu")
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, variables))
    manager = CheckpointManager(str(directory))
    manager.save(0, {"model": model})
    manager.wait()
    return str(directory)


def write_a2d_val(root, videos=3, n_frames=8):
    """An A2D-Sentences val tree of ``videos`` mp4 clips (the layout of
    tests/torch_data_fixtures.write_a2d_tree)."""
    import cv2
    import h5py

    (root / "Release" / "clips320H").mkdir(parents=True)
    rng = np.random.default_rng(7)
    ann, split = ["video_id,instance_id,query"], []
    for v in range(videos):
        vid = f"vid{v}"
        d = root / "text_annotations" / "a2d_annotation_with_instances" / vid
        d.mkdir(parents=True)
        writer = cv2.VideoWriter(str(root / "Release" / "clips320H" / f"{vid}.mp4"),
                                 cv2.VideoWriter_fourcc(*"mp4v"), 10, (W, H))
        for _ in range(n_frames):
            writer.write((rng.random((H, W, 3)) * 255).astype(np.uint8))
        writer.release()
        mask = np.zeros((H, W), np.uint8)
        mask[10 + 5 * v:40, 20:50 + 5 * v] = 1
        heat = mask[None].astype(np.float32)
        with h5py.File(d / "00004.h5", "w") as f:
            f.create_dataset("instance", data=np.asarray([2]))
            f.create_dataset("reMask", data=mask.T)
            f.create_dataset("heatBBox", data=heat)
            f.create_dataset("heatPoint", data=heat)
        ann.append(f"{vid},2,a person running {'left' if v % 2 else 'right'}")
        split.append(f"{vid},x,x,x,x,x,x,x,1")
    (root / "text_annotations" / "a2d_annotation.txt").write_text("\n".join(ann) + "\n")
    (root / "Release" / "videoset.csv").write_text("\n".join(split) + "\n")
    return root


def write_refcoco(root, n_train=8, n_val=2):
    """A COCO root with train2014/ JPEGs and instances_refcoco_{train,val}.json
    (the schema of tests/test_e2e_pretrain.py)."""
    (root / "train2014").mkdir(parents=True)
    rng = np.random.default_rng(5)

    def coco_json(names):
        images, anns = [], []
        for i, name in enumerate(names):
            Image.fromarray((rng.random((H, W, 3)) * 255).astype(np.uint8)).save(
                root / "train2014" / name)
            x, y = int(rng.integers(4, 30)), int(rng.integers(4, 24))
            images.append({"id": i, "file_name": name, "height": H, "width": W,
                           "caption": "the red square thing on the left"})
            anns.append({"id": i, "image_id": i, "category_id": 1, "bbox": [x, y, 32, 24],
                         "segmentation": [[x, y, x + 32, y, x + 32, y + 24, x, y + 24]],
                         "area": 32 * 24, "iscrowd": 0})
        return {"images": images, "annotations": anns,
                "categories": [{"id": 1, "name": "object"}]}

    for split, names in (("train", [f"t{i}.jpg" for i in range(n_train)]),
                         ("val", [f"v{i}.jpg" for i in range(n_val)])):
        with open(root / f"instances_refcoco_{split}.json", "w") as f:
            json.dump(coco_json(names), f)
    return root


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_cli")
    return {"a2d": write_a2d_val(root / "a2d"),
            "jhmdb": fx.write_jhmdb_tree(root / "jhmdb", h=H, w=W),
            "refcoco": write_refcoco(root / "refcoco")}


def _eval_argv(trees, dataset):
    return ["--dataset_file", dataset, f"--{dataset}_path", str(trees[dataset]),
            "--backbone", "resnet50", "--num_frames", "3", *CANVAS,
            "--config_overrides", json.dumps(TINY_CFG)]


@pytest.fixture(scope="module")
def jax_evaluate_runs(trees, tmp_path_factory):
    """{dataset: (metrics, a port checkpoint of the JAX CLI's weights)}."""
    from ocpg_tpu.engine import evaluate as jax_evaluate

    runs = {}
    for dataset in ("a2d", "jhmdb"):
        params = []
        with jax_cli(_eval_argv(trees, dataset) + ["--batch_size", "1"]) as (mp, out):
            capture_arg(mp, jax_evaluate, "evaluate_a2d", 1, params)
            jax_evaluate_cli.main()
        cfg = apply_config_overrides(OCPGConfig(backbone="resnet50", dataset_file=dataset),
                                     json.dumps(TINY_CFG))
        ckpt = port_checkpoint(params[0], cfg, tmp_path_factory.mktemp(f"ckpt_{dataset}"))
        runs[dataset] = (json.loads(out.getvalue()), ckpt)
    return runs


@pytest.mark.parametrize("dataset", ["a2d", "jhmdb"])
def test_evaluate_cli_matches_jax(dataset, trees, jax_evaluate_runs):
    want, ckpt = jax_evaluate_runs[dataset]
    got = evaluate_cli.main(_eval_argv(trees, dataset)
                            + ["--batch_size", "2", "--checkpoint", ckpt, "--device", "cpu"])
    assert got.keys() == want.keys()
    for k in want:
        assert np.isfinite(got[k]) and 0.0 <= got[k] <= 1.0, (k, got[k])
        assert abs(got[k] - want[k]) <= METRIC_ATOL, (k, got[k], want[k])


def test_eval_davis_cli_matches_jax(tmp_path):
    _write_davis(tmp_path, np.random.default_rng(9))
    for name in ("port", "jax"):
        shutil.copytree(tmp_path / "results", tmp_path / name)
    got = eval_davis_cli.main(["--davis_path", str(tmp_path),
                               "--results_path", str(tmp_path / "port")])
    with jax_cli(["--davis_path", str(tmp_path), "--results_path", str(tmp_path / "jax")]):
        jax_eval_davis_cli.main()
    for csv in ("global_results-val.csv", "per-sequence_results-val.csv"):
        assert (tmp_path / "port" / csv).read_text() == (tmp_path / "jax" / csv).read_text()
    assert 0.0 < got["J&F-Mean"] < 1.0


def _pretrain_argv(trees, out_dir):
    return ["--dataset_file", "refcoco", "--coco_path", str(trees["refcoco"]),
            "--backbone", "resnet50", "--batch_size", "2", "--epochs", "1",
            "--eval_batch_size", "2", "--output_dir", str(out_dir), *CANVAS,
            "--config_overrides", json.dumps(TINY_CFG), "--device", "cpu"]


@pytest.fixture(scope="module")
def jax_pretrain_step(trees):
    """The JAX pretrain CLI's first batch (its loader on one device: the
    refcoco train JSON, T = 1, batch 2, the compact wire), seeded weights
    in the train tree's shapes, and JAX's deterministic loss, losses and
    gradient norm on that batch with them."""
    from ocpg_tpu.config import OCPGConfig as JaxConfig
    from ocpg_tpu.data.loader import ClipLoader as JaxClipLoader
    from ocpg_tpu.data.loader import decompress_batch as jax_decompress_batch
    from ocpg_tpu.data.refexp import RefExpDataset as JaxRefExp
    from ocpg_tpu.models import build_model as jax_build_model
    from ocpg_tpu.models.criterion import compute_criterion as jax_compute_criterion
    from ocpg_tpu.models.text_encoder import SimpleTokenizer as JaxTokenizer

    from tests.test_torch_train_model import _jax, _jax_args, _train_variables

    root = trees["refcoco"]
    jcfg = JaxConfig(backbone="resnet50", dataset_file="refcoco", supervision="full",
                     num_frames=1, batch_size=2, msda_impl="xla", **TINY_CFG)
    dataset = JaxRefExp(root / "train2014", root / "instances_refcoco_train.json",
                        num_frames=1, as_sequence=False)
    loader = JaxClipLoader(dataset, 2, tokenizer=JaxTokenizer(None, vocab_size=jcfg.text_vocab),
                           train=True, seed=jcfg.seed, canvas=(H, W), compact=True)
    batch = next(iter(loader.epoch(0)))
    jmodel, _, crit_cfg, weight_dict = jax_build_model(jcfg)
    host = dict(batch)
    host.update(jax.tree_util.tree_map(np.asarray, jax_decompress_batch(batch)))
    variables = _train_variables(jmodel, host, seed=4)

    def loss_fn(params, frozen):
        out = jmodel.apply({"params": params, "frozen": frozen}, *_jax_args(host),
                           targets=_jax(host["targets"]), train=True, deterministic=True)
        return jax_compute_criterion(crit_cfg, weight_dict, out, _jax(host["targets"]),
                                     jnp.asarray(0))

    (total, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        _jax(variables["params"]), _jax(variables["frozen"]))
    norm = float(jnp.sqrt(sum(jnp.sum(g * g) for g in jax.tree_util.tree_leaves(grads))))
    want = {"loss": float(total), "grad_norm": norm,
            **{k: float(v) for k, v in losses.items()}}
    return batch, variables, want


def _log(out_dir):
    with open(out_dir / "log.txt") as f:
        return [json.loads(line) for line in f if line.strip()]


def test_pretrain_cli_against_jax(trees, tmp_path, jax_pretrain_step, monkeypatch):
    from ocpg_tpu_torch.data.loader import ClipLoader
    from ocpg_tpu_torch.data.refexp import RefExpDataset
    from ocpg_tpu_torch.engine.train import TrainStep
    from ocpg_tpu_torch.models.text_encoder import SimpleTokenizer

    from tests.test_torch_data import assert_batches_equal
    from tests.test_torch_train_model import LOSS_RTOL, NORM_RTOL

    want_batch, variables, want = jax_pretrain_step
    built, steps, evals = [], [], []
    build = port_build.build_model

    def build_with_jax_weights(cfg, device=None, generator=None):
        model = build(cfg, device, generator)
        load_jax_params(model, variables)
        built.append(model)
        return model

    step_call = TrainStep.__call__

    def step_and_keep(self, batch):
        self.deterministic = True        # dropout's bits cannot be JAX's
        metrics = step_call(self, batch)
        steps.append((jax.tree_util.tree_map(lambda t: t.numpy(), batch), metrics))
        return metrics

    refexp_loop = port_evaluate.evaluate_refexp_loop

    def eval_and_keep_weights(model, loader, **kw):
        evals.append({k: v.clone() for k, v in model.state_dict().items()})
        return refexp_loop(model, loader, **kw)

    monkeypatch.setattr(port_build, "build_model", build_with_jax_weights)
    monkeypatch.setattr(TrainStep, "__call__", step_and_keep)
    monkeypatch.setattr(port_evaluate, "evaluate_refexp_loop", eval_and_keep_weights)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)   # no tensorflow
    out_dir = tmp_path / "run"
    pretrain_cli.main(_pretrain_argv(trees, out_dir))

    # the first step: the JAX CLI's first batch, JAX's losses and gradient norm
    first_batch, got = steps[0]
    assert len(steps) == 4                                # 8 images, batches of 2
    assert_batches_equal(first_batch, want_batch)
    assert got["finite"] == 1.0
    for k, v in want.items():
        rtol = NORM_RTOL if k == "grad_norm" else LOSS_RTOL
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=1e-6, err_msg=k)

    (rec,) = _log(out_dir)
    assert rec["epoch"] == 0 and rec["loss"] == got["loss"]
    val_keys = sorted(k for k in rec if k.startswith("refcoco_"))
    for prefix in ("refcoco_bbox_", "refcoco_segm_", "refcoco_coco_bbox_"):
        assert any(k.startswith(prefix) for k in val_keys), prefix
    assert all(np.isfinite(rec[k]) for k in val_keys)

    # the eval model ran with the trained weights, which the checkpoint holds
    saved = CheckpointManager(str(out_dir / "checkpoints")).restore()
    assert saved["train_step"]["step"] == 4
    trained, (at_eval,) = built[0].state_dict(), evals
    for k, v in saved["model"].items():
        assert torch.equal(at_eval[k], v) and torch.equal(trained[k], v), k
    assert built[1].cfg.dataset_file == "refcoco"
    fresh = build(built[1].cfg, "cpu")
    fresh.load_state_dict(saved["model"])
    val = RefExpDataset(str(trees["refcoco"] / "train2014"),
                        str(trees["refcoco"] / "instances_refcoco_val.json"))
    loader = ClipLoader(val, 2, tokenizer=SimpleTokenizer(vocab_size=TINY_CFG["text_vocab"]),
                        train=False, seed=42, canvas=(H, W), compact=True)
    again = refexp_loop(fresh, loader, device="cpu")
    assert {f"refcoco_{k}": v for k, v in again.items()} == {k: rec[k] for k in val_keys}


class _FirstStep(Exception):
    """Raised by a patched TrainStep to end a CLI run at its first step."""


@pytest.mark.parametrize("cli,argv", [
    ("evaluate", ["--dataset_file", "jhmdb", "--jhmdb_path", "x", "--device", "cpu"]),
    ("pretrain", ["--coco_path", "x", "--device", "cpu"]),
])
def test_unported_flags_and_the_gpu_default(cli, argv, trees, tmp_path, monkeypatch):
    """The flags that were refused before: evaluate with a reference .pth
    ``--checkpoint`` and ``--tokenizer_path`` (the toy vocabulary of
    chip_smoke.py) gives the JAX CLI's metrics with the same flags;
    pretrain's first batch with ``--tokenizer_path`` is the JAX loader's
    with JAX's tokenizer on that vocabulary.  Without a GPU the default
    device raises."""
    import chip_smoke
    from tests.test_torch_pretrained import save_replica_pth

    vocab = tmp_path / "vocab"
    vocab.mkdir()
    chip_smoke.write_toy_vocab(str(vocab))
    if cli == "evaluate":
        save_replica_pth(tmp_path / "ref.pth")
        flags = _eval_argv(trees, "jhmdb") + ["--batch_size", "1", "--checkpoint",
                                               str(tmp_path / "ref.pth"),
                                               "--tokenizer_path", str(vocab)]
        with jax_cli(flags) as (_, out):
            jax_evaluate_cli.main()
        want = json.loads(out.getvalue())
        got = evaluate_cli.main(flags + ["--device", "cpu"])
        assert got.keys() == want.keys()
        for k in want:
            assert abs(got[k] - want[k]) <= METRIC_ATOL, (k, got[k], want[k])
    else:
        from ocpg_tpu.config import OCPGConfig as JaxConfig
        from ocpg_tpu.data.loader import ClipLoader as JaxClipLoader
        from ocpg_tpu.data.refexp import RefExpDataset as JaxRefExp
        from ocpg_tpu.models.text_encoder import SimpleTokenizer as JaxTokenizer

        from ocpg_tpu_torch.engine.train import TrainStep
        from tests.test_torch_data import assert_batches_equal

        batches = []

        def first_step(self, batch):
            batches.append(jax.tree_util.tree_map(lambda t: t.numpy(), batch))
            raise _FirstStep

        monkeypatch.setattr(TrainStep, "__call__", first_step)
        with pytest.raises(_FirstStep):
            pretrain_cli.main(_pretrain_argv(trees, tmp_path / "run")
                              + ["--tokenizer_path", str(vocab)])
        root = trees["refcoco"]
        dataset = JaxRefExp(root / "train2014", root / "instances_refcoco_train.json",
                            num_frames=1, as_sequence=False)
        seed = JaxConfig(dataset_file="refcoco", **TINY_CFG).seed
        loader = JaxClipLoader(dataset, 2, tokenizer=JaxTokenizer(
            str(vocab), vocab_size=TINY_CFG["text_vocab"]), train=True, seed=seed,
            canvas=(H, W), compact=True)
        assert_batches_equal(batches[0], next(iter(loader.epoch(0))))
        assert batches[0]["text_ids"].max() < chip_smoke.TOY_VOCAB_SIZE
    main = {"evaluate": evaluate_cli.main, "pretrain": pretrain_cli.main}[cli]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([a for a in argv if a not in ("--device", "cpu")])
