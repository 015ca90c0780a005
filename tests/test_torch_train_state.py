"""The port's train state on the CPU: the compact batch wire
(``data/loader.py::decompress_batch``, against the JAX function), the train
step fed a compact batch, and the checkpoints (``engine/checkpoint.py``):
a round trip, an exact resume, the rolling deletion and the finetune merge.

The model is the tiny ResNet config of tests/test_torch_model.py in
float32.  Bounds: ``decompress_batch`` within 1e-6 of JAX (the same float32
arithmetic); the step fed the compact batch within 1e-6 relative of the
step fed JAX's expansion of it; a restored state and a resumed run
bit-identical, on the CPU.
"""
import copy

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ocpg_tpu.data.loader import decompress_batch as jax_decompress_batch

from ocpg_tpu_torch.data.loader import decompress_batch
from ocpg_tpu_torch.data.synthetic import synthetic_batch
from ocpg_tpu_torch.engine.checkpoint import (CheckpointManager, load_params,
                                              restore_params_into)
from ocpg_tpu_torch.engine.optim import build_optimizer
from ocpg_tpu_torch.engine.train import make_train_step
from ocpg_tpu_torch.models.build import build_model, build_weight_dict, criterion_config

from tests.test_torch_model import _jax_cfg, port_config
from tests.torch_threads import one_torch_thread  # noqa: F401

B, T, H, W = 1, 2, 64, 80


def compact_batch(seed):
    """A compact-wire batch as ``pad_to_canvas(compact=True)`` makes it:
    uint8 frames zero on the canvas padding (the last 16 columns and 8
    rows), uint8 binary masks, float16 heatmaps."""
    rng = np.random.default_rng(seed)
    batch = synthetic_batch(rng, batch=B, frames=T, height=H, width=W, text_len=8,
                            vocab_size=1000)
    h, w = H - 8, W - 16
    frames = np.zeros((B, T, H, W, 3), np.uint8)
    frames[:, :, :h, :w] = rng.integers(0, 256, (B, T, h, w, 3))
    batch["samples"] = frames
    batch["samples_mask"] = np.ones((B, T, H, W), bool)
    batch["samples_mask"][:, :, :h, :w] = False
    tg = batch["targets"]
    for k, dtype in (("masks", np.uint8), ("weights", np.float16), ("weak_masks", np.uint8)):
        tg[k][:, :, h:] = 0
        tg[k][:, :, :, w:] = 0
        tg[k] = tg[k].astype(dtype)
    tg["size"][:] = (h, w)
    return batch


def _tree(batch, fn):
    return {k: (_tree(v, fn) if isinstance(v, dict) else fn(v)) for k, v in batch.items()}


def test_decompress_batch_matches_jax():
    batch = compact_batch(seed=0)
    want = _tree(jax_decompress_batch(_tree(batch, jnp.asarray)), np.asarray)
    got = decompress_batch(_tree(batch, torch.from_numpy))
    assert got["samples"].dtype == torch.float32
    np.testing.assert_allclose(got["samples"].numpy(), want["samples"], atol=1e-6)
    pad = batch["samples_mask"]
    assert (got["samples"].numpy()[pad] == 0).all()        # zeros in normalised space
    assert (got["samples"].numpy()[~pad] != 0).any()
    for k in ("masks", "weights", "weak_masks"):
        assert got["targets"][k].dtype == torch.float32, k
        np.testing.assert_array_equal(got["targets"][k].numpy(), want["targets"][k])
    for k in ("labels", "boxes", "valid", "size"):
        assert got["targets"][k].dtype == torch.from_numpy(batch["targets"][k]).dtype
    # a float32 batch passes through
    f32 = _tree(_tree(want, np.array), torch.from_numpy)
    again = decompress_batch(f32)
    assert again["samples"] is f32["samples"]
    assert all(again["targets"][k] is f32["targets"][k] for k in f32["targets"])


def _cfg():
    return port_config(_jax_cfg("ytvos"))


def _step(seed=None, deterministic=True, lr_drop_steps=()):
    """A fresh model (weights drawn from ``seed``, default cfg.seed),
    optimizer and train step."""
    cfg = _cfg()
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    model = build_model(cfg, device="cpu", generator=gen)
    opt = build_optimizer(model, cfg, lr_drop_steps=lr_drop_steps)
    step = make_train_step(model, criterion_config(cfg), build_weight_dict(cfg), opt,
                           deterministic=deterministic)
    return model, opt, step


def test_train_step_takes_the_compact_batch():
    compact = compact_batch(seed=1)
    f32 = _tree(jax_decompress_batch(_tree(compact, jnp.asarray)), np.array)
    runs = []
    for batch in (compact, f32):
        model, _, step = _step()
        metrics = step(batch)
        runs.append((metrics, {k: p.detach().clone() for k, p in model.named_parameters()}))
    (got, got_p), (want, want_p) = runs
    assert got["finite"] == 1.0 and got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-7, err_msg=k)
    for k, v in want_p.items():
        np.testing.assert_allclose(got_p[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_debug_images_metric():
    model, _, step = _step()
    step.debug_images = True
    pred = step(compact_batch(seed=2))["debug_pred"]
    assert isinstance(pred, np.ndarray) and pred.shape == (H, W)
    assert ((pred >= 0) & (pred <= 1)).all()


def _state(model, opt, step):
    return {"model": model, "optimizer": opt, "train_step": step}


def _assert_same(a, b, path=""):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, path
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}/{i}")
    else:
        assert a == b, (path, a, b)


def test_checkpoint_round_trip(tmp_path):
    model, opt, step = _step(deterministic=False)
    step(compact_batch(seed=3))
    saved = {k: copy.deepcopy(v.state_dict()) for k, v in _state(model, opt, step).items()}
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, _state(model, opt, step))
    # the snapshot is taken at save: the next step, which updates the live
    # parameters and moments in place, does not reach the file
    step(compact_batch(seed=5))
    restored = CheckpointManager(str(tmp_path / "ckpt")).restore()
    assert set(restored) == {"model", "optimizer", "train_step"}
    assert restored["train_step"]["step"] == 1 and restored["optimizer"]["count"] == 1
    for name in saved:
        _assert_same(restored[name], saved[name], name)


def test_exact_resume(tmp_path):
    """N + M steps in one run against N steps, a save, a restore into fresh
    objects (other initial weights), then M steps: dropout on, an LR
    boundary after the resume; parameters, moments, metrics, counters and
    the generator bit-equal."""
    n, m = 2, 2
    batches = [synthetic_batch(np.random.default_rng(10 + i), batch=B, frames=T, height=H,
                               width=W, text_len=8, vocab_size=1000) for i in range(n + m)]
    model_a, opt_a, step_a = _step(deterministic=False, lr_drop_steps=(3,))
    metrics_a = [step_a(b) for b in batches]

    model_b, opt_b, step_b = _step(deterministic=False, lr_drop_steps=(3,))
    for b in batches[:n]:
        step_b(b)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(n, _state(model_b, opt_b, step_b))
    del model_b, opt_b, step_b

    model_c, opt_c, step_c = _step(seed=99, deterministic=False)
    restored = CheckpointManager(str(tmp_path / "ckpt")).restore()
    for name, obj in _state(model_c, opt_c, step_c).items():
        obj.load_state_dict(restored[name])
    assert opt_c.lr_drop_steps == (3,) and step_c.state["step"] == n
    metrics_c = [step_c(b) for b in batches[n:]]

    assert metrics_c == metrics_a[n:]
    _assert_same(model_c.state_dict(), model_a.state_dict())
    _assert_same(opt_c.state_dict(), opt_a.state_dict())
    _assert_same(step_c.state_dict(), step_a.state_dict())


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    model, opt, step = _step()
    for s in (5, 10, 15, 20):
        step.state["step"] = s
        mgr.save(s, {"train_step": step})
    assert mgr.latest_step() == 20
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["ckpt_15.pt",
                                                                     "ckpt_20.pt"]
    assert mgr.restore(15)["train_step"]["step"] == 15
    with pytest.raises(FileNotFoundError):
        load_params(str(tmp_path / "empty"), model)


def test_load_params_for_inference(tmp_path):
    model, opt, step = _step(deterministic=False)
    step(compact_batch(seed=4))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, _state(model, opt, step))
    fresh, _, _ = _step(seed=7)
    load_params(str(tmp_path / "ckpt"), fresh)        # waits for the write in flight
    _assert_same(fresh.state_dict(), model.state_dict())


def test_restore_params_into_merges_and_drops_class_head():
    """As tests/test_engine.py holds the JAX merge: the class heads keep the
    target's, a matching entry takes the source's, an entry missing from the
    source or of another shape keeps the target's."""
    target = {"class_embed_0.weight": torch.zeros(4, 1),
              "controller.layers_0.weight": torch.zeros(4, 4),
              "extra.weight": torch.zeros(2, 2),
              "shape_mismatch.weight": torch.zeros(2, 3)}
    source = {"class_embed_0.weight": torch.ones(4, 1),
              "controller.layers_0.weight": torch.ones(4, 4, dtype=torch.float64),
              "shape_mismatch.weight": torch.ones(3, 3)}
    out = restore_params_into(target, source, drop_prefixes=("class_embed",))
    assert (out["class_embed_0.weight"] == 0).all()
    assert (out["controller.layers_0.weight"] == 1).all()
    assert out["controller.layers_0.weight"].dtype == torch.float32
    assert (out["extra.weight"] == 0).all() and (out["shape_mismatch.weight"] == 0).all()
    # nested module names: a dotted component that starts with the prefix
    out = restore_params_into({"head.class_embed_1.bias": torch.zeros(2)},
                              {"head.class_embed_1.bias": torch.ones(2)})
    assert (out["head.class_embed_1.bias"] == 0).all()
    out = restore_params_into(target, source, drop_prefixes=())
    assert (out["class_embed_0.weight"] == 1).all()
