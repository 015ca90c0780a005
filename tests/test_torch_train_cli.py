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
"""
import json

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


def _argv(tree, out_dir, epochs, debug_images_every=2):
    return ["--dataset_file", "ytvos", "--backbone", "resnet50", "--supervision", "box",
            "--num_frames", NUM_FRAMES, "--batch_size", "1", "--epochs", str(epochs),
            "--num_workers", "2", "--ytvos_path", str(tree), "--output_dir", str(out_dir),
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


def _cli_pieces(tree, tmp_path):
    args = train_cli.get_args(_argv(tree, tmp_path, epochs=1))
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


def test_cli_train_step_matches_jax_with_carried_weights(tree, tmp_path):
    _, cfg, batch = _cli_pieces(tree, tmp_path)
    jcfg = JaxConfig(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__},
                     msda_impl="xla")
    jmodel, _, crit_cfg, weight_dict = jax_build_model(jcfg)
    host = dict(batch)
    host.update(jax.tree_util.tree_map(np.asarray, jax_decompress_batch(batch)))
    variables = _train_variables(jmodel, host, seed=2)

    def loss_fn(params, frozen):
        out = jmodel.apply({"params": params, "frozen": frozen}, *_jax_args(host),
                           targets=_jax(host["targets"]), train=True, deterministic=True)
        return jax_compute_criterion(crit_cfg, weight_dict, out, _jax(host["targets"]),
                                     jnp.asarray(0))

    (total, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        _jax(variables["params"]), _jax(variables["frozen"]))

    model = build_model(cfg, device="cpu")
    assert load_jax_params(model, variables) == []
    step = TrainStep(model, criterion_config(cfg), build_weight_dict(cfg),
                     build_optimizer(model, cfg), deterministic=True)
    metrics = step(batch)                # the compact host batch, as the CLI feeds it
    assert metrics["finite"] == 1.0
    np.testing.assert_allclose(metrics["loss"], float(total), rtol=LOSS_RTOL)
    for k, v in losses.items():
        np.testing.assert_allclose(metrics[k], float(v), rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    norm = float(jnp.sqrt(sum(jnp.sum(g * g) for g in jax.tree_util.tree_leaves(grads))))
    np.testing.assert_allclose(metrics["grad_norm"], norm, rtol=NORM_RTOL)


def test_config_overrides_refuse_the_jax_only_fields():
    cfg = OCPGConfig()
    assert apply_config_overrides(cfg, None) is cfg
    assert apply_config_overrides(cfg, '{"enc_layers": 2}').enc_layers == 2
    for key in ("msda_impl", "swin_attn_impl", "data_parallel", "prng_impl", "nope"):
        with pytest.raises(TypeError):
            apply_config_overrides(cfg, json.dumps({key: 1}))


def test_cli_help_and_unported_flags(tree, tmp_path, capsys):
    with pytest.raises(SystemExit):
        train_cli.get_args(["--help"])
    text = capsys.readouterr().out
    assert "--device" in text and "msda_impl" in text and "prng_impl" in text
    for flag in ("--pretrained_weights", "--tokenizer_path"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
            train_cli.main(_argv(tree, tmp_path, 1) + [flag, "x"])
    for flag, value in (("--prng_impl", "rbg"), ("--msda_impl", "xla")):
        with pytest.raises(SystemExit):
            train_cli.get_args([flag, value])


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
