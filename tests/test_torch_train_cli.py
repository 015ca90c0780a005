"""The port's train CLI on the CPU (``--device cpu``), on the JAX package's
end-to-end tree and config (tests/test_e2e_train.py: 10 frames of 64 x 80,
one expression, TINY_CFG), against the JAX package.

* One epoch, then ``--resume`` for a second, with the assertions of
  tests/test_e2e_train.py's train-and-resume test: configs, log.txt,
  checkpoints, debug images, the resumed epoch, the latest step.
* The first batch the CLI's loader emits equals the JAX loader's built the
  same way (exact: the readers, transforms and wire are).
* JAX parameters carried across (``load_jax_params``): one deterministic
  ``TrainStep`` on that batch matches JAX's loss and gradient norm within
  the tolerances of tests/test_torch_train_model.py (each loss 1e-5
  relative, grad_norm 3e-5).
* ``--pretrained_weights`` and ``--tokenizer_path``: the weights at the
  first step are JAX's conversion of a replica checkpoint (class heads at
  their init), the first batch the JAX loader's with the same tokenizer.
"""
import json
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ocpg_tpu.config import OCPGConfig as JaxConfig
from ocpg_tpu.data.datasets import build_dataset as jax_build_dataset
from ocpg_tpu.data.loader import ClipLoader as JaxClipLoader
from ocpg_tpu.data.loader import decompress_batch as jax_decompress_batch
from ocpg_tpu.models import build_model as jax_build_model
from ocpg_tpu.models.criterion import compute_criterion as jax_compute_criterion
from ocpg_tpu.models.text_encoder import SimpleTokenizer as JaxTokenizer

from ocpg_tpu_torch.cli import train as train_cli
from ocpg_tpu_torch.config import OCPGConfig, apply_config_overrides
from ocpg_tpu_torch.engine.checkpoint import CheckpointManager
from ocpg_tpu_torch.engine.optim import build_optimizer
from ocpg_tpu_torch.engine.train import TrainStep
from ocpg_tpu_torch.models.build import build_model, build_weight_dict, criterion_config
from ocpg_tpu_torch.utils.weights import load_jax_params

from tests import torch_data_fixtures as fx
from tests.test_e2e_train import TINY_CFG
from tests.test_torch_data import assert_batches_equal
from tests.test_torch_train_model import LOSS_RTOL, NORM_RTOL, _jax, _jax_args, _train_variables
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return fx.write_ytvos_tree(tmp_path_factory.mktemp("ytvos_e2e"))


NUM_FRAMES = "2"


def _argv(tree, out_dir, epochs, debug_images_every=2, dataset="ytvos", supervision="box"):
    return ["--dataset_file", dataset, "--backbone", "resnet50", "--supervision", supervision,
            "--num_frames", NUM_FRAMES, "--batch_size", "1", "--epochs", str(epochs),
            "--num_workers", "2", f"--{dataset}_path", str(tree), "--output_dir", str(out_dir),
            "--canvas", "64", "80", "--log_every", "1", "--tb_every", "0",
            "--debug_images_every", str(debug_images_every),
            "--config_overrides", json.dumps(TINY_CFG), "--device", "cpu"]


def test_train_cli_and_resume(tree, tmp_path):
    out_dir = tmp_path / "run"
    steps_per_epoch = 10        # 10 metas, batch 1, one device
    train_cli.main(_argv(tree, out_dir, epochs=1))
    assert (out_dir / "configs").exists()
    with open(out_dir / "log.txt") as f:
        lines = [json.loads(line) for line in f if line.strip()]
    assert len(lines) == 1 and lines[0]["epoch"] == 0
    assert np.isfinite(lines[0]["loss"]) and lines[0]["loss"] > 0
    assert lines[0]["data_time_s"] >= 0 and lines[0]["step_time_s"] > 0
    ckpt_dir = out_dir / "checkpoints"
    assert ckpt_dir.is_dir() and any(ckpt_dir.iterdir())
    debug = sorted((out_dir / "debug_images").glob("*.png"))
    assert len(debug) >= 3 and any("pred" in p.name for p in debug)

    train_cli.main(_argv(tree, out_dir, epochs=2) + ["--resume", str(ckpt_dir)])
    with open(out_dir / "log.txt") as f:
        lines = [json.loads(line) for line in f if line.strip()]
    assert lines[-1]["epoch"] == 1 and np.isfinite(lines[-1]["loss"])
    assert CheckpointManager(str(ckpt_dir)).latest_step() == 2 * steps_per_epoch


def _cli_pieces(tree, tmp_path, extra=(), **kw):
    args = train_cli.get_args(_argv(tree, tmp_path, epochs=1, **kw) + list(extra))
    cfg = train_cli.make_config(args)
    loader = train_cli.make_loader(args, cfg, train_cli.make_dataset(args, cfg))
    return args, cfg, next(iter(loader.epoch(0)))


def test_cli_first_batch_matches_the_jax_loader(tree, tmp_path):
    """The JAX CLI's loader on one device: batch_size x 1, its tokenizer,
    the compact wire."""
    args, cfg, got = _cli_pieces(tree, tmp_path)
    jds = jax_build_dataset("ytvos", str(tree), "train", cfg.num_frames, cfg.supervision)
    jax_loader = JaxClipLoader(jds, cfg.batch_size, tokenizer=JaxTokenizer(
        None, vocab_size=cfg.text_vocab), train=True, seed=cfg.seed, canvas=(64, 80),
        num_workers=args.num_workers, compact=True)
    want = next(iter(jax_loader.epoch(0)))
    assert got["samples"].dtype == np.uint8
    assert_batches_equal(got, want)


def _carried_step_matches_jax(cfg, batch):
    """JAX's parameters carried into the port: one deterministic TrainStep on
    the CLI's compact batch against JAX's loss, losses and gradient norm."""
    jcfg = JaxConfig(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__},
                     msda_impl="xla")
    jmodel, _, crit_cfg, weight_dict = jax_build_model(jcfg)
    host = dict(batch)
    host.update(jax.tree_util.tree_map(np.asarray, jax_decompress_batch(batch)))
    variables = _train_variables(jmodel, host, seed=2)
    vidx = host.get("valid_indices")

    def loss_fn(params, frozen):
        out = jmodel.apply({"params": params, "frozen": frozen}, *_jax_args(host),
                           targets=_jax(host["targets"]),
                           valid_indices=None if vidx is None else jnp.asarray(vidx),
                           train=True, deterministic=True)
        return jax_compute_criterion(crit_cfg, weight_dict, out, _jax(host["targets"]),
                                     jnp.asarray(0))

    (total, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        _jax(variables["params"]), _jax(variables["frozen"]))

    model = build_model(cfg, device="cpu")
    assert load_jax_params(model, variables) == []
    step = TrainStep(model, criterion_config(cfg), build_weight_dict(cfg),
                     build_optimizer(model, cfg), deterministic=True,
                     has_valid_indices=vidx is not None)
    metrics = step(batch)                # the compact host batch, as the CLI feeds it
    assert metrics["finite"] == 1.0
    np.testing.assert_allclose(metrics["loss"], float(total), rtol=LOSS_RTOL)
    assert {k for k in metrics if k.startswith("loss_")} >= set(losses)
    for k, v in losses.items():
        np.testing.assert_allclose(metrics[k], float(v), rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    norm = float(jnp.sqrt(sum(jnp.sum(g * g) for g in jax.tree_util.tree_leaves(grads))))
    np.testing.assert_allclose(metrics["grad_norm"], norm, rtol=NORM_RTOL)
    return metrics, losses


def test_cli_train_step_matches_jax_with_carried_weights(tree, tmp_path):
    _, cfg, batch = _cli_pieces(tree, tmp_path)
    _carried_step_matches_jax(cfg, batch)


@pytest.fixture(scope="module")
def a2d_tree(tmp_path_factory):
    """The A2D tree with a point heat map that marks the object (0.9 over
    its box, as the generator's peak does), so point supervision has a weak
    mask and box."""
    return fx.write_a2d_tree(tmp_path_factory.mktemp("a2d"), point_heat=0.9)


def test_a2d_batch_carries_the_annotated_frame_targets_once(a2d_tree, tmp_path):
    """The fault the port repairs: JAX's loader broadcasts an A2D clip's one
    annotated frame's mask, weak mask and heat map over the clip's T
    frames, which JAX's own train forward (the annotated frame alone after
    valid_indices) cannot match against; the port's loader carries them
    once, equal to JAX's first copy, and JAX's model takes that batch."""
    args, cfg, got = _cli_pieces(a2d_tree, tmp_path, dataset="a2d")
    jds = jax_build_dataset("a2d", str(a2d_tree), "train", cfg.num_frames, cfg.supervision)
    jax_loader = JaxClipLoader(jds, cfg.batch_size, tokenizer=JaxTokenizer(
        None, vocab_size=cfg.text_vocab), train=True, seed=cfg.seed, canvas=(64, 80),
        num_workers=args.num_workers, compact=True)
    want = next(iter(jax_loader.epoch(0)))
    t = want["samples"].shape[1]
    assert t == 3 and got["samples"].shape == want["samples"].shape
    for k in ("masks", "weak_masks", "weights"):
        jt = want["targets"][k]
        assert jt.shape[1] == t and (jt == jt[:, :1]).all(), k
        assert got["targets"][k].shape[1] == 1, k
        np.testing.assert_array_equal(got["targets"][k], jt[:, :1], err_msg=k)
    maps = ("masks", "weak_masks", "weights")
    assert_batches_equal(
        {**got, "targets": {k: v for k, v in got["targets"].items() if k not in maps}},
        {**want, "targets": {k: v for k, v in want["targets"].items() if k not in maps}})

    jmodel, *_ = jax_build_model(JaxConfig(
        **{k: getattr(cfg, k) for k in cfg.__dataclass_fields__}, msda_impl="xla"))

    def forward_shapes(batch):
        """JAX's train forward on ``batch``, traced (shapes only)."""
        host = dict(batch)
        host.update(jax.tree_util.tree_map(np.asarray, jax_decompress_batch(batch)))
        return jax.eval_shape(lambda: jmodel.init_with_output(
            jax.random.PRNGKey(0), *_jax_args(host), targets=_jax(host["targets"]),
            valid_indices=jnp.asarray(host["valid_indices"]), train=True,
            deterministic=True)[0])

    with pytest.raises(TypeError, match="incompatible shapes"):
        forward_shapes(want)
    assert forward_shapes(got)["pred_masks_layers"].shape[2:] == (1, 64, 80)


def test_a2d_point_box_is_the_weak_mask_box(a2d_tree, tmp_path):
    """The other fault the port repairs: the JAX reader (after the
    reference) scales the point heat map's pixel box by (w, h) once more,
    which clips it to the image's corner, so its loader finds no valid
    point-supervised clip; the port's box is the weak mask's pixel box."""
    from ocpg_tpu.data.datasets import A2DSentencesDataset as JaxA2D
    from ocpg_tpu_torch.data.datasets import A2DSentencesDataset

    port, jds = A2DSentencesDataset(str(a2d_tree), 3, "point"), JaxA2D(str(a2d_tree), 3, "point")
    got, want = (d.get_clip(0, random.Random(0)).clip for d in (port, jds))
    h, w = got.size
    np.testing.assert_array_equal(want.boxes, [[w, h, w, h]])
    ys, xs = np.nonzero(got.weak_masks[0])
    assert len(ys) and np.array_equal(got.weak_masks, want.weak_masks)
    # weight2mask's box: centre of mass -+ half the extent, in pixel units
    np.testing.assert_allclose(got.boxes, [[xs.min() - 0.5, ys.min() - 0.5, xs.max() + 0.5,
                                            ys.max() + 0.5]])
    with pytest.raises(RuntimeError, match="no valid sample"):
        next(iter(JaxClipLoader(jds, 1, tokenizer=JaxTokenizer(None, vocab_size=2048),
                                train=True, seed=0, canvas=(64, 80)).epoch(0)))
    assert _cli_pieces(a2d_tree, tmp_path, dataset="a2d", supervision="point")[2][
        "targets"]["valid"].all()


# the recipe variants: (dataset, --supervision, other flags)
RECIPE_VARIANTS = [
    ("a2d", "box", []),
    ("a2d", "point", ["--supervision_type", "partialsup"]),
    ("a2d", "box", ["--supervision_type", "boxinst"]),
    ("a2d", "full", []),
    ("ytvos", "box", ["--freeze_video_encoder"]),
]


@pytest.mark.parametrize("dataset,supervision,extra", RECIPE_VARIANTS,
                         ids=["a2d-box", "a2d-point-partialsup", "a2d-box-boxinst", "a2d-full",
                              "ytvos-box-freeze_video_encoder"])
def test_cli_recipe_variant_step_matches_jax_with_carried_weights(
        tree, a2d_tree, tmp_path, dataset, supervision, extra):
    """The recipes' variants through the CLI's own flags: the first batch of
    the A2D reader (valid_indices) with box, point and full supervision,
    BoxInst's pairwise losses, the frozen video encoder (its gradients
    still enter the clip's norm, as in JAX)."""
    _, cfg, batch = _cli_pieces(a2d_tree if dataset == "a2d" else tree, tmp_path, extra,
                                dataset=dataset, supervision=supervision)
    assert (cfg.dataset_file, cfg.supervision) == (dataset, supervision)
    assert cfg.pairwise_loss == ("boxinst" in extra)
    assert cfg.freeze_video_encoder == ("--freeze_video_encoder" in extra)
    assert ("valid_indices" in batch) == (dataset == "a2d")
    metrics, losses = _carried_step_matches_jax(cfg, batch)
    assert ("loss_pairwise" in losses) == ("loss_pairwise" in metrics) == cfg.pairwise_loss


def test_config_overrides_refuse_the_jax_only_fields():
    cfg = OCPGConfig()
    assert apply_config_overrides(cfg, None) is cfg
    assert apply_config_overrides(cfg, '{"enc_layers": 2}').enc_layers == 2
    for key in ("msda_impl", "swin_attn_impl", "data_parallel", "prng_impl", "nope"):
        with pytest.raises(TypeError):
            apply_config_overrides(cfg, json.dumps({key: 1}))


class _FirstStep(Exception):
    """Raised by a patched TrainStep to end a CLI run at its first step."""


def test_cli_help_and_unported_flags(tree, tmp_path, capsys, monkeypatch):
    """The help, the JAX-only flags refused, and the flags that were
    refused before: with ``--pretrained_weights`` (a replica .pth) and
    ``--tokenizer_path`` (the toy vocabulary of chip_smoke.py), the model at
    the first step holds JAX's conversion of the checkpoint except the
    class heads, which keep the model's init, and the first batch is the
    JAX loader's with JAX's tokenizer on that vocabulary."""
    import chip_smoke
    from tests.test_torch_pretrained import converted_state_dict, save_replica_pth

    with pytest.raises(SystemExit):
        train_cli.get_args(["--help"])
    text = capsys.readouterr().out
    assert "--device" in text and "msda_impl" in text and "prng_impl" in text
    for flag, value in (("--prng_impl", "rbg"), ("--msda_impl", "xla")):
        with pytest.raises(SystemExit):
            train_cli.get_args([flag, value])

    vocab = tmp_path / "vocab"
    vocab.mkdir()
    chip_smoke.write_toy_vocab(str(vocab))
    sd = save_replica_pth(tmp_path / "ref.pth")
    first = []

    def first_step(self, batch):
        first.append(({k: v.clone() for k, v in self.model.state_dict().items()}, batch))
        raise _FirstStep

    monkeypatch.setattr(TrainStep, "__call__", first_step)
    argv = _argv(tree, tmp_path / "run", 1) + ["--pretrained_weights", str(tmp_path / "ref.pth"),
                                               "--tokenizer_path", str(vocab)]
    with pytest.raises(_FirstStep):
        train_cli.main(argv)
    state, batch = first[0]
    cfg = train_cli.make_config(train_cli.get_args(argv))
    init = build_model(cfg, device="cpu").state_dict()
    want = converted_state_dict(sd, "resnet50")
    assert state.keys() == init.keys() == want.keys()
    for k, v in state.items():
        expected = init[k] if k.startswith("class_embed_") else torch.from_numpy(want[k])
        assert torch.equal(v, expected), k
    assert not torch.equal(init["class_embed_0.weight"],
                           torch.from_numpy(want["class_embed_0.weight"]))

    jds = jax_build_dataset("ytvos", str(tree), "train", cfg.num_frames, cfg.supervision)
    jax_loader = JaxClipLoader(jds, cfg.batch_size, tokenizer=JaxTokenizer(
        str(vocab), vocab_size=cfg.text_vocab), train=True, seed=cfg.seed, canvas=(64, 80),
        num_workers=2, compact=True)
    assert_batches_equal(jax.tree_util.tree_map(lambda t: t.numpy(), batch),
                         next(iter(jax_loader.epoch(0))))
    assert batch["text_ids"].max() < chip_smoke.TOY_VOCAB_SIZE


def test_cli_needs_a_gpu_unless_asked_for_the_cpu(tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    argv = [a for a in _argv(tree, tmp_path, 1) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(argv)


def test_train_path_with_no_debug_images_imports_no_cv2(tree, tmp_path):
    """The CLI's dataset, loader and prefetch over a whole epoch, in a fresh
    interpreter: no cv2 (the resizes and colors are numpy)."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "from ocpg_tpu_torch.cli import train as t\n"
        "from ocpg_tpu_torch.parallel import prefetch_to_mesh\n"
        f"args = t.get_args({_argv(tree, tmp_path, 1, debug_images_every=0)!r})\n"
        "cfg = t.make_config(args)\n"
        "loader = t.make_loader(args, cfg, t.make_dataset(args, cfg))\n"
        "n = sum(1 for _ in prefetch_to_mesh(loader.epoch(0), 'cpu'))\n"
        "assert n == 10 and 'cv2' not in sys.modules, (n, 'cv2' in sys.modules)\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=repo))
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stdout + res.stderr


def test_logging_and_profiling_utilities(tmp_path, monkeypatch):
    """The CLI's meters, JSONL log, TensorBoard writer (through a stand-in
    ``torch.utils.tensorboard``: the real one imports tensorflow here; a
    no-op without a logdir), StepTimer split and torch.profiler trace."""
    import sys
    import types

    from ocpg_tpu_torch.utils.logging import JSONLLogger, MetricMeter, TensorBoardLogger
    from ocpg_tpu_torch.utils.profiling import StepTimer, device_memory_stats, trace

    meter = MetricMeter(window=2)
    for v in (1.0, 2.0, 6.0):
        meter.update({"loss": v})
    assert meter.averages() == {"loss": 3.0} and str(meter) == "loss=4.0000"
    log = JSONLLogger(tmp_path / "sub" / "log.txt")
    log.write({"epoch": 0})
    log.write({"epoch": 1})
    assert [json.loads(x)["epoch"] for x in
            (tmp_path / "sub" / "log.txt").read_text().splitlines()] == [0, 1]
    TensorBoardLogger(None).scalars(0, {"loss": 1.0})
    written = []

    class Writer:
        def __init__(self, logdir):
            written.append(("dir", logdir))

        def add_scalar(self, k, v, global_step):
            written.append((k, v, global_step))

        def flush(self):
            pass

        def close(self):
            written.append("closed")

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=Writer))
    tb = TensorBoardLogger(tmp_path / "tb")
    tb.scalars(3, {"loss": 1.5})
    tb.close()
    assert written == [("dir", str(tmp_path / "tb")), ("loss", 1.5, 3), "closed"]
    timer = StepTimer()
    for _ in range(2):
        timer.data_ready()
        timer.step_done()
    avg = timer.averages()
    assert set(avg) == {"data_time_s", "step_time_s"} and min(avg.values()) >= 0
    with trace(str(tmp_path / "prof")):
        torch.ones(8).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    with trace(None):
        pass
    if not torch.cuda.is_available():
        assert device_memory_stats() == {}
