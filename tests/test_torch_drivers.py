"""The port's whole-system scripts (``ocpg_tpu_torch/scripts/``) on the CPU
against the JAX package's (``scripts/``, loaded from their files, never
edited), at small sizes.

* ``demo_synthetic_e2e``: ``build_tree`` writes the JAX script's files byte
  for byte at the same seed; ``score`` gives the JAX script's J&F on the
  same result PNGs (exact: the DAVIS metrics are); a tiny run (``--device
  cpu``, one epoch, one train and one valid video of 2 frames, float32)
  gives a record with the JAX script's keys and finite values.
* ``train_long_run``: ``synthetic_val_jf`` with JAX's weights carried by
  ``load_jax_params`` into a small config gives JAX's J and F on the same
  two compact batches within 1e-3 (the two frameworks' float32 logits
  differ by ~1e-6, which can flip a few pixels at the 0.5 threshold); a
  short run on a Ref-YouTube-VOS tree has the JAX record's keys, the
  restored state bit-identical to the saved one and, on the CPU, a replay
  bit-exact with the live losses, twice (the CPU adds in a fixed order; on
  the GPU the MSDA and scatter-add backwards add with atomics, so the
  script records the difference there instead).  The checkpoint falls
  right before a val, so the replay also shows that the val draws nothing
  from the dropout generator.
* ``memory_envelope``: its grid is the JAX script's, ``--quick`` keeps the
  same rows, and a row that runs out of memory is recorded as such.
"""
import ast
import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ocpg_tpu.config import OCPGConfig as JaxConfig
from ocpg_tpu.models import build_model as jax_build_model

from ocpg_tpu_torch.config import OCPGConfig
from ocpg_tpu_torch.data.datasets import build_dataset
from ocpg_tpu_torch.data.loader import ClipLoader
from ocpg_tpu_torch.models.build import build_model
from ocpg_tpu_torch.scripts import demo_synthetic_e2e as demo
from ocpg_tpu_torch.scripts import memory_envelope
from ocpg_tpu_torch.scripts import train_long_run as long_run
from ocpg_tpu_torch.utils.weights import load_jax_params

from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
VAL_JF_ATOL = 1e-3

# a small model of the ResNet-50 family (the train CLI tests' widths)
SMALL = dict(backbone="resnet50", enc_layers=1, dec_layers=2, dim_feedforward=64,
             num_queries=5, num_frames=2, compute_dtype="float32", dataset_file="ytvos",
             text_layers=2, text_hidden=128, text_heads=4, text_ffn=256, text_vocab=2048)


def jax_script(name):
    """A JAX script of ``scripts/`` as a module, loaded from its file."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_source_function(name, function):
    tree = ast.parse((REPO / "scripts" / f"{name}.py").read_text())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == function)


def jax_record_keys(name, function, variable):
    """The keys of the dict literal assigned to ``variable`` in a JAX
    script's function, and those it assigns by subscript afterwards."""
    keys = set()
    for node in ast.walk(jax_source_function(name, function)):
        if isinstance(node, ast.Assign):
            target = node.targets[0]
            if (isinstance(target, ast.Name) and target.id == variable
                    and isinstance(node.value, ast.Dict)):
                keys |= {k.value for k in node.value.keys}
            if (isinstance(target, ast.Subscript) and isinstance(target.value, ast.Name)
                    and target.value.id == variable):
                keys.add(target.slice.value)
    return keys


def files_of(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


# ------------------------------------------------------------------ demo --
def test_demo_tree_is_the_jax_scripts_byte_for_byte(tmp_path):
    jax_demo = jax_script("demo_synthetic_e2e")
    jax_demo.build_tree(tmp_path / "jax", 2, 2, seed=5)
    demo.build_tree(tmp_path / "port", 2, 2, seed=5)
    want, got = files_of(tmp_path / "jax"), files_of(tmp_path / "port")
    assert len(want) == 2 * 2 * 8 + 2 * 3 * 8 + 3
    assert list(got) == list(want)
    assert [k for k in want if got[k] != want[k]] == []


def test_demo_score_matches_jax(tmp_path):
    """Result PNGs made from the tree's ground truth (a shifted copy, an
    object dropped, an empty frame) scored by both scripts."""
    from PIL import Image

    tree = tmp_path / "davis"
    demo.build_tree(tree, 1, 2, seed=3)
    rng = np.random.default_rng(0)
    out = tmp_path / "out"
    for anno in range(4):
        for video in ("va0", "va1"):
            d = out / "valid" / f"anno_{anno}" / video
            d.mkdir(parents=True)
            for t in range(demo.N_FRAMES):
                gt = np.asarray(Image.open(tree / "Annotations" / video / f"{t:05d}.png"))
                pred = np.roll(gt, (int(rng.integers(-6, 7)), int(rng.integers(-6, 7))), (0, 1))
                if anno == 1:
                    pred = np.where(pred == 2, 0, pred)
                if anno == 2 and t == 3:
                    pred = np.zeros_like(pred)
                Image.fromarray(pred.astype(np.uint8)).save(d / f"{t:05d}.png")
    want = jax_script("demo_synthetic_e2e").score(tree, out)
    got = demo.score(tree, out)
    assert got == want
    assert 0 < got["jf_mean"] < 1


def test_demo_tiny_run_has_the_jax_record(tmp_path, monkeypatch):
    monkeypatch.setattr(demo, "N_FRAMES", 2)
    out = tmp_path / "record.json"
    record = demo.main(["--device", "cpu", "--epochs", "1", "--train_videos", "1",
                        "--valid_videos", "1", "--workers", "1", "--dtype", "float32",
                        "--workdir", str(tmp_path / "work"), "--out", str(out)])
    assert set(record) == jax_record_keys("demo_synthetic_e2e", "main", "record")
    assert json.loads(out.read_text()) == record
    assert record["platform"] == "cpu" and record["devices"] == 0
    assert record["steps"] == 1 * 1 * 2 * 2
    assert record["train"]["epochs"] == 1
    assert all(math.isfinite(record["train"][k]) for k in ("loss_first", "loss_last"))
    for run in ("random", "trained"):
        jf = [record[run]["jf_mean"], *record[run]["jf_per_annotator"]]
        assert len(jf) == 5 and all(0.0 <= v <= 1.0 for v in jf)
    assert record["jf_random"] == record["random"]["jf_mean"]
    assert (tmp_path / "work" / "train" / "checkpoints").is_dir()


# -------------------------------------------------------------- long run --
@pytest.fixture(scope="module")
def long_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("long_run")
    long_run.build_tree(str(root / "ytvos"), 2, 4, 72, 128, dataset="ytvos")
    return root / "ytvos"


def test_synthetic_val_jf_matches_jax_with_carried_weights(long_tree):
    cfg = OCPGConfig(**SMALL)
    dataset = build_dataset("ytvos", str(long_tree), "train", cfg.num_frames, "box")
    loader = ClipLoader(dataset, 1, canvas=(64, 80), train=True, num_workers=1,
                        text_vocab=cfg.text_vocab, compact=True)
    batches = [b for _, b in zip(range(2), loader.epoch(0))]
    assert batches[0]["samples"].dtype == np.uint8

    jcfg = JaxConfig(**SMALL, msda_impl="xla")
    jmodel, *_ = jax_build_model(jcfg)
    b = batches[0]
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros(b["samples"].shape, jnp.float32),
        jnp.asarray(b["samples_mask"]), jnp.asarray(b["text_ids"]),
        jnp.asarray(b["text_mask"]), jnp.asarray(b["targets"]["size"]), train=False))
    rng = np.random.default_rng(4)

    def fill(path, x):
        if str(getattr(path[-1], "key", path[-1])) == "running_var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (rng.standard_normal(x.shape) * 0.05).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    want = jax_script("train_long_run").synthetic_val_jf(jmodel, variables, batches)

    model = build_model(cfg, device="cpu")
    load_jax_params(model, variables)
    model.train()
    got = long_run.synthetic_val_jf(model, batches)
    assert model.training
    np.testing.assert_allclose(got, want, atol=VAL_JF_ATOL)
    assert 0 < want[0] < 1 and 0 < want[1] < 1


def test_long_run_resume_on_the_cpu(tmp_path):
    steps, ckpt, replay = 8, 4, 2
    out = tmp_path / "TRAIN_LONG.json"
    record = long_run.run(long_run.LongRunConfig(
        steps=steps, ckpt_step=ckpt, replay_steps=replay, eval_every=4, videos=2,
        frames_per_video=4, device="cpu", out=str(out), model=OCPGConfig(**SMALL),
        canvas=(64, 80), frame_size=(72, 128)))
    assert json.loads(out.read_text()) == record
    want_keys = jax_record_keys("train_long_run", "main", "artifact")
    assert want_keys <= set(record)
    assert set(record) - want_keys == {
        "platform", "devices", "dataset", "params_m", "tree", "peak_memory_gib",
        "resume_state_bit_identical", "resume_max_rel_diff", "replay_repeat_max_rel_diff",
        "replay_losses_repeat"}
    assert record["dataset"] == "ytvos" and record["platform"] == "cpu"
    assert record["steps"] == steps and len(record["curve_every_20"]) == 1
    assert record["resume_state_bit_identical"] and record["resume_replay_steps"] == replay
    assert [p["step"] for p in record["val_jf_curve"]] == [1, 4, 8]
    assert all(0 <= p["J"] <= 1 and 0 <= p["F"] <= 1 for p in record["val_jf_curve"])
    losses = (record["replay_losses_live"] + record["replay_losses_restored"]
              + record["replay_losses_repeat"])
    assert len(losses) == 3 * replay and all(math.isfinite(v) for v in losses)
    # on the CPU every sum has a fixed order: the replays are the live run
    assert record["resume_bit_exact"]
    assert record["replay_losses_repeat"] == record["replay_losses_live"]
    assert record["resume_max_rel_diff"] == record["replay_repeat_max_rel_diff"] == 0.0


def test_first_difference_finds_one_bit():
    state = {"model": {"w": torch.ones(3), "n": torch.tensor(2)}, "step": {"step": 4}}
    flipped = {"model": {"w": torch.ones(3), "n": torch.tensor(2)}, "step": {"step": 4}}
    assert long_run.first_difference(flipped, state) is None
    flipped["model"]["w"][1] = torch.nextafter(torch.tensor(1.0), torch.tensor(2.0))
    assert long_run.first_difference(flipped, state) == "/model/w"
    assert long_run.first_difference({**state, "step": {"step": 5}}, state) == "/step/step"
    negative_zero = {"model": {"w": torch.tensor([1.0, -0.0, 1.0]), "n": torch.tensor(2)},
                     "step": {"step": 4}}
    zero = {"model": {"w": torch.tensor([1.0, 0.0, 1.0]), "n": torch.tensor(2)},
            "step": {"step": 4}}
    assert long_run.first_difference(negative_zero, zero) == "/model/w"


# -------------------------------------------------------------- envelope --
def jax_grid(variable):
    for node in ast.walk(jax_source_function("hbm_envelope", "main")):
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == variable and isinstance(node.value, ast.List)):
            return [tuple(row) for row in ast.literal_eval(node.value)]
    raise KeyError(variable)


def test_envelope_grid_is_the_jax_scripts():
    train, evals = jax_grid("train_grid"), jax_grid("eval_grid")
    assert len(train) == 7 and len(evals) == 5
    assert memory_envelope.grids(False) == (train, evals)
    assert memory_envelope.grids(True) == (train[:2], evals[:2])


def test_envelope_records_an_out_of_memory_row():
    key = {"mode": "train", "backbone": "resnet101", "batch": 4, "frames": 3,
           "canvas": "512x640", "remat": False}
    message = "CUDA out of memory. Tried to allocate 2.00 GiB"

    def oom():
        raise torch.cuda.OutOfMemoryError(message)

    row = memory_envelope.measure(oom, key, "cpu", 80 * 2 ** 30)
    assert set(row) == set(key) | {"status", "error", "wall_s"}
    assert {k: row[k] for k in key} == key
    assert row["status"] == "oom" and row["error"] == message and row["wall_s"] >= 0

    def fault():
        raise ValueError("not a memory error")

    with pytest.raises(ValueError):
        memory_envelope.measure(fault, key, "cpu", 80 * 2 ** 30)


def test_envelope_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("the envelope runs on this host's GPU")
    with pytest.raises(RuntimeError, match="GPU"):
        memory_envelope.envelope(quick=True)
