"""The port's train forward and train step against the JAX package, on the CPU.

The tiny config of tests/test_torch_model.py (ResNet-50, 1 + 2 layers, a
2-layer RoBERTa) in float32, the JAX side with the XLA MSDA (gather
forward, separable-autodiff backward), the port's through the plain MSDA
and autograd.  Weights: the shapes of a train-mode JAX init (with the two
level-set modules), filled with seeded noise, carried into the port by
``load_jax_params``.  Dropout is off on both sides (JAX's dropout bits
cannot be reproduced): ``deterministic=True`` and ``model.eval()``.

Tolerances:

* forward outputs at the golden bounds of tests/test_golden_parity.py
  (logits and boxes 2e-3; masks and level-set features 5e-3 of their max
  |.|), the matched queries identical;
* each loss at 1e-5 relative and ``grad_norm`` at 3e-5 (measured: 1e-6
  and 3.4e-6; float32 sums in another order through the same stacks);
* every parameter's gradient at 1e-4 of that leaf's max |g| (measured:
  5e-6), with max |g| floored at 1e-6: the attention q/k biases have
  gradients that are zero but for rounding (~1e-11), which the two
  frameworks round differently; the first Adam moment, 0.1 x the clipped
  gradient after one step, likewise.

Adam-updated parameters are not compared: the first step is about
``lr * sign(g)``, so it flips on gradients near zero.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from ocpg_tpu.engine.optim import build_optimizer as jax_build_optimizer
from ocpg_tpu.models import build_model as jax_build_model
from ocpg_tpu.models.criterion import compute_criterion as jax_compute_criterion

from ocpg_tpu_torch.data.synthetic import synthetic_batch
from ocpg_tpu_torch.engine.optim import build_optimizer
from ocpg_tpu_torch.engine.train import make_train_step
from ocpg_tpu_torch.models.build import build_model, build_weight_dict, criterion_config
from ocpg_tpu_torch.utils.weights import jax_to_state_dict, load_jax_params

from tests.test_torch_model import _jax_cfg, port_config
from tests.torch_threads import one_torch_thread  # noqa: F401

B, T, H, W, LT = 1, 2, 96, 128, 8
LOGIT_ATOL, MASK_ATOL = 2e-3, 5e-3
LOSS_RTOL = 1e-5
NORM_RTOL = 3e-5
GRAD_ATOL = 1e-4


def _batch(seed, with_valid_indices=False):
    batch = synthetic_batch(np.random.default_rng(seed), batch=B, frames=T, height=H,
                            width=W, text_len=LT, vocab_size=1000,
                            with_valid_indices=with_valid_indices)
    batch["samples_mask"][..., -16:] = True        # right padding
    batch["targets"]["size"][:] = (H, W - 16)
    batch["text_mask"][:, -2:] = 0
    batch["text_ids"][:, -2:] = 1
    return batch


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _train_variables(jmodel, batch, seed):
    """Seeded noise in the shapes of a train-mode init (running variances
    kept positive)."""
    vidx = batch.get("valid_indices")
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), *_jax_args(batch), targets=_jax(batch["targets"]),
        valid_indices=None if vidx is None else jnp.asarray(vidx), train=True))
    rng = np.random.default_rng(seed)

    def fill(path, x):
        if str(getattr(path[-1], "key", path[-1])) == "running_var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (rng.standard_normal(x.shape) * 0.05).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jax_args(batch):
    return tuple(jnp.asarray(batch[k]) for k in
                 ("samples", "samples_mask", "text_ids", "text_mask")) + (
        jnp.asarray(batch["targets"]["size"]),)


def _port_args(batch):
    return tuple(torch.from_numpy(np.asarray(batch[k])) for k in
                 ("samples", "samples_mask", "text_ids", "text_mask")) + (
        torch.from_numpy(batch["targets"]["size"]),)


def _port_targets(batch):
    return {k: torch.from_numpy(v) for k, v in batch["targets"].items()}


def _scaled_close(got, want, atol, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-6)
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def ytvos():
    """JAX model, weights, batch, and the JAX loss, outputs and gradients of
    one deterministic train step at step 0."""
    jcfg = _jax_cfg("ytvos")
    jmodel, _, crit_cfg, weight_dict = jax_build_model(jcfg)
    batch = _batch(seed=4)
    variables = _train_variables(jmodel, batch, seed=2)

    def loss_fn(params, frozen):
        out = jmodel.apply({"params": params, "frozen": frozen}, *_jax_args(batch),
                           targets=_jax(batch["targets"]), train=True, deterministic=True)
        total, losses = jax_compute_criterion(crit_cfg, weight_dict, out,
                                              _jax(batch["targets"]), jnp.asarray(0))
        return total, (losses, out)

    (total, (losses, out)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        _jax(variables["params"]), _jax(variables["frozen"]))
    return dict(jcfg=jcfg, variables=variables, batch=batch, total=float(total),
                losses={k: float(v) for k, v in losses.items()},
                out=jax.tree_util.tree_map(np.asarray, out),
                grads=jax.tree_util.tree_map(np.asarray, grads))


def _adam_first_moment(opt_state):
    """The optax chain's Adam ``mu`` of every trained leaf, by port key."""
    nested = {}
    adams = jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
    for adam in adams:
        if not isinstance(adam, optax.ScaleByAdamState):
            continue
        for path, leaf in jax.tree_util.tree_flatten_with_path(adam.mu)[0]:
            *mods, last = [str(getattr(k, "key", k)) for k in path]
            node = nested
            for m in mods:
                node = node.setdefault(m, {})
            node[last] = np.asarray(leaf)
    return jax_to_state_dict({"params": nested})


def _port_model(jcfg, variables):
    model = build_model(port_config(jcfg), device="cpu")
    assert load_jax_params(model, variables) == []
    return model


def _check_train_outputs(got, want):
    np.testing.assert_array_equal(got["matched"].numpy(), want["matched"])
    for k in ("outputs_class", "outputs_coord"):
        np.testing.assert_allclose(got[k].detach().numpy(), want[k], atol=LOGIT_ATOL,
                                   err_msg=k)
    for k in ("pred_masks_layers", "pred_masks_low_layers", "ls_features", "frames"):
        _scaled_close(got[k].detach().numpy(), want[k], MASK_ATOL, k)


def test_train_forward_matches_jax_ytvos(ytvos):
    model = _port_model(ytvos["jcfg"], ytvos["variables"])
    out = model(*_port_args(ytvos["batch"]), targets=_port_targets(ytvos["batch"]),
                train=True)
    _check_train_outputs(out, ytvos["out"])


def test_train_forward_matches_jax_a2d_with_valid_indices():
    jcfg = _jax_cfg("a2d")
    jmodel, *_ = jax_build_model(jcfg)
    batch = _batch(seed=5, with_valid_indices=True)
    batch["valid_indices"][:] = 1
    # one annotated frame per clip: the targets are those of that frame
    batch["targets"] = {k: (v[:, 1:2] if v.ndim > 1 and k != "size" else v)
                        for k, v in batch["targets"].items()}
    variables = _train_variables(jmodel, batch, seed=3)
    want = jax.jit(lambda v, a, t, vi: jmodel.apply(
        v, *a, targets=t, valid_indices=vi, train=True, deterministic=True))(
        _jax(variables), _jax_args(batch), _jax(batch["targets"]),
        jnp.asarray(batch["valid_indices"]))
    model = _port_model(jcfg, variables)
    got = model(*_port_args(batch), torch.from_numpy(batch["valid_indices"]),
                targets=_port_targets(batch), train=True)
    assert got["pred_masks_layers"].shape == (2, B, 1, H, W)
    _check_train_outputs(got, jax.tree_util.tree_map(np.asarray, want))


def test_train_step_matches_jax(ytvos):
    cfg = port_config(ytvos["jcfg"])
    model = _port_model(ytvos["jcfg"], ytvos["variables"])
    optimizer = build_optimizer(model, cfg, lr_drop_steps=[1000])
    step = make_train_step(model, criterion_config(cfg), build_weight_dict(cfg), optimizer,
                           deterministic=True)
    metrics = step(ytvos["batch"])
    assert metrics["finite"] == 1.0 and step.state["step"] == 1
    np.testing.assert_allclose(metrics["loss"], ytvos["total"], rtol=LOSS_RTOL)
    assert set(ytvos["losses"]) <= set(metrics)
    for k, v in ytvos["losses"].items():
        np.testing.assert_allclose(metrics[k], v, rtol=LOSS_RTOL, atol=1e-6, err_msg=k)

    # grad_norm over every gradient (frozen leaves included), before the clip
    leaves = jax.tree_util.tree_leaves(ytvos["grads"])
    jax_norm = float(optax.global_norm(leaves))
    np.testing.assert_allclose(metrics["grad_norm"], jax_norm, rtol=NORM_RTOL)

    # per-leaf gradients, clipped as optax clips them
    clip = min(1.0, cfg.clip_max_norm / jax_norm)
    want = jax_to_state_dict({"params": ytvos["grads"]})
    params = dict(model.named_parameters())
    for name, g in want.items():
        p = params[name]
        got = np.zeros_like(g) if p.grad is None else p.grad.numpy()
        _scaled_close(got, g * clip, GRAD_ATOL, name)

    # the first Adam moment against optax's, on the same (JAX) gradients
    jopt = jax_build_optimizer(ytvos["jcfg"], lr_drop_steps=[1000])
    jparams = _jax(ytvos["variables"]["params"])
    _, jstate = jax.jit(jopt.update)(_jax(ytvos["grads"]), jopt.init(jparams), jparams)
    mu = _adam_first_moment(jstate)
    trained = {id(p) for g in optimizer.adamw.param_groups for p in g["params"]}
    checked = 0
    for name, p in params.items():
        if id(p) not in trained:
            continue
        _scaled_close(optimizer.adamw.state[p]["exp_avg"].numpy(), mu[name], GRAD_ATOL,
                      f"exp_avg {name}")
        checked += 1
    assert checked == len(trained)


def test_non_finite_step_leaves_params_and_state(ytvos):
    cfg = port_config(ytvos["jcfg"])
    model = _port_model(ytvos["jcfg"], ytvos["variables"])
    optimizer = build_optimizer(model, cfg)
    step = make_train_step(model, criterion_config(cfg), build_weight_dict(cfg), optimizer,
                           deterministic=True)
    step(ytvos["batch"])                     # a real step: Adam state exists
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state_before = {id(p): {k: v.clone() for k, v in s.items()}
                    for p, s in optimizer.adamw.state.items()}
    nan_batch = dict(ytvos["batch"])
    nan_batch["samples"] = nan_batch["samples"].copy()
    nan_batch["samples"][0, 0, 0, 0, 0] = np.nan
    metrics = step(nan_batch)
    assert metrics["finite"] == 0.0
    assert step.state["step"] == 2 and optimizer.count == 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for p, s in optimizer.adamw.state.items():
        for k, v in s.items():
            assert torch.equal(v, state_before[id(p)][k]), k


def test_eval_tree_loads_with_the_level_set_modules_at_init():
    """A JAX tree from an eval-mode init lacks exactly the two train-only
    modules: they stay at their init and are named; anything else missing
    still raises (test_torch_model.py::test_load_jax_params_is_strict)."""
    from tests.test_torch_model import random_variables

    jmodel, *_ = jax_build_model(_jax_cfg("davis"))
    variables = random_variables(jmodel, seed=1)
    model = build_model(port_config(_jax_cfg("davis")), device="cpu")
    init = {k: v.clone() for k, v in model.state_dict().items()}
    left = load_jax_params(model, variables)
    assert left == ["ls_feat_viz.bias", "ls_feat_viz.weight", "ls_text_proj.bias",
                    "ls_text_proj.weight"]
    for k in left:
        assert torch.equal(model.state_dict()[k], init[k])
    del variables["params"]["controller"]
    with pytest.raises(KeyError, match="controller"):
        load_jax_params(model, variables)
