"""The port's Swin train path against the JAX package, on the CPU.

* ``DropPath`` by its statistics (keep frequency within four standard
  deviations of the binomial's, kept branches scaled by ``1 / keep``), and
  each block's rate against the rate the JAX backbone hands its block;
* one train step of the ``video_swin_test`` OCPG model (the tiny config of
  tests/test_torch_model.py with the Swin backbone, float32) against the
  JAX step, with stochastic depth and dropout off on both sides
  (``deterministic``): losses within 1e-5 relative, every gradient within
  1e-4 of its leaf's max |g|, as tests/test_torch_train_model.py holds the
  ResNet step (tests/test_torch_swin_remat.py repeats it with
  ``use_checkpoint``);
* with stochastic depth and dropout on and the same generator seed, the
  gradients with ``use_checkpoint`` equal those without (1e-6): the
  recompute must apply the masks the forward drew;
* ``param_group_label`` for a Swin backbone, with and without
  ``freeze_video_encoder``, against the JAX labels.
"""
import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp
import optax
import torch

from ocpg_tpu.engine.optim import param_group_label as jax_param_group_label
from ocpg_tpu.models import backbone_video_swin as jax_swin
from ocpg_tpu.models import build_model as jax_build_model
from ocpg_tpu.models.criterion import compute_criterion as jax_compute_criterion

from ocpg_tpu_torch.engine.optim import build_optimizer, param_group_label
from ocpg_tpu_torch.engine.train import make_train_step
from ocpg_tpu_torch.models import backbone_video_swin
from ocpg_tpu_torch.models.build import build_model, build_weight_dict, criterion_config
from ocpg_tpu_torch.models.layers import DropPath
from ocpg_tpu_torch.utils.weights import _flatten, _port_key, jax_to_state_dict

from tests.test_torch_model import _jax_cfg, port_config, random_variables
from tests.test_torch_train_model import (GRAD_ATOL, LOSS_RTOL, NORM_RTOL, _batch, _jax,
                                          _jax_args, _port_model, _scaled_close,
                                          _train_variables)
from tests.torch_threads import one_torch_thread  # noqa: F401


def _swin_cfg(use_checkpoint=False):
    return _jax_cfg("ytvos").replace(backbone="video_swin_test", use_checkpoint=use_checkpoint)


# --------------------------------------------------------------- DropPath --
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_drop_path_statistics(p):
    n = 100_000
    drop = DropPath(p).train()
    drop.generator = torch.Generator().manual_seed(3)
    keep = drop.draw(n, torch.device("cpu"))
    assert keep.shape == (n, 1, 1, 1, 1) and keep.dtype == torch.bool
    freq = keep.float().mean().item()
    assert abs(freq - (1 - p)) <= 4 * np.sqrt(p * (1 - p) / n), freq
    x = torch.full((n, 2, 1, 1, 3), 2.0)
    y = drop(x, keep)
    kept = keep.reshape(n)
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0 / (1 - p)))
    assert torch.equal(y[~kept], torch.zeros_like(y[~kept]))
    drop.generator = torch.Generator().manual_seed(3)
    assert torch.equal(drop.draw(n, torch.device("cpu")), keep)      # same seed, same mask
    assert drop.eval().draw(n, torch.device("cpu")) is None          # identity in eval mode
    assert DropPath(0.0).train().draw(n, torch.device("cpu")) is None
    assert torch.equal(drop(x, None), x)


@pytest.mark.parametrize("arch", ["video_swin_test", "video_swin_b_p4w7"])
def test_drop_path_rates_match_jax(arch):
    """The rate the JAX backbone gives each block (read off its calls) is
    the port block's, in block order."""
    rates = []

    def record(next_fun, args, kwargs, context):
        if isinstance(context.module, jax_swin.SwinBlock3D) and context.method_name == "__call__":
            rates.append((context.module.name, context.module.drop_path))
        return next_fun(*args, **kwargs)

    jmod = jax_swin.build_video_swin(arch, num_frames=1)
    with nn.intercept_methods(record):
        jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    port = backbone_video_swin.build_video_swin(arch)
    got = [(name, mod.drop_path.p) for name, mod in port.named_children()
           if isinstance(mod, backbone_video_swin.SwinBlock3D)]
    assert [n for n, _ in got] == [n for n, _ in rates]
    np.testing.assert_allclose([r for _, r in got], [r for _, r in rates], rtol=1e-12)
    assert got[0][1] == 0.0 and got[-1][1] == pytest.approx(0.2)


# ------------------------------------------------------ train step vs JAX --
@pytest.fixture(scope="module")
def weights():
    """Seeded noise in the shapes of a train-mode init of the Swin model,
    and the batch."""
    jmodel, *_ = jax_build_model(_swin_cfg())
    batch = _batch(seed=6)
    return dict(batch=batch, variables=_train_variables(jmodel, batch, seed=8))


def _jax_step(jcfg, variables, batch):
    """The JAX loss, losses and gradients of one deterministic step at step 0."""
    jmodel, _, crit_cfg, weight_dict = jax_build_model(jcfg)

    def loss_fn(params, frozen):
        out = jmodel.apply({"params": params, "frozen": frozen}, *_jax_args(batch),
                           targets=_jax(batch["targets"]), train=True, deterministic=True)
        return jax_compute_criterion(crit_cfg, weight_dict, out, _jax(batch["targets"]),
                                     jnp.asarray(0))

    (total, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        _jax(variables["params"]), _jax(variables.get("frozen", {})))
    return float(total), {k: float(v) for k, v in losses.items()}, \
        jax.tree_util.tree_map(np.asarray, grads)


def check_swin_train_step(weights, use_checkpoint):
    """One deterministic port step against the JAX step (see the docstring)."""
    jcfg = _swin_cfg(use_checkpoint)
    total, losses, grads = _jax_step(jcfg, weights["variables"], weights["batch"])
    cfg = port_config(jcfg)
    assert cfg.use_checkpoint == use_checkpoint
    model = _port_model(jcfg, weights["variables"])
    assert model.backbone.use_checkpoint == use_checkpoint
    step = make_train_step(model, criterion_config(cfg), build_weight_dict(cfg),
                           build_optimizer(model, cfg), deterministic=True)
    metrics = step(weights["batch"])
    assert metrics["finite"] == 1.0
    np.testing.assert_allclose(metrics["loss"], total, rtol=LOSS_RTOL)
    for k, v in losses.items():
        np.testing.assert_allclose(metrics[k], v, rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    jax_norm = float(optax.global_norm(jax.tree_util.tree_leaves(grads)))
    np.testing.assert_allclose(metrics["grad_norm"], jax_norm, rtol=NORM_RTOL)
    clip = min(1.0, cfg.clip_max_norm / jax_norm)
    params = dict(model.named_parameters())
    want = jax_to_state_dict({"params": grads})
    assert any(k.startswith("backbone.stage2_block1.") for k in want)
    for name, g in want.items():
        p = params[name]
        got = np.zeros_like(g) if p.grad is None else p.grad.numpy()
        _scaled_close(got, g * clip, GRAD_ATOL, name)


def test_swin_train_step_matches_jax(weights):
    check_swin_train_step(weights, use_checkpoint=False)


def test_recompute_keeps_the_stochastic_depth_masks(weights):
    """Stochastic depth and dropout on, one generator seed: the gradients
    with per-block recompute equal those without.  Every block's rate is set
    to 0.5, so that its ten keep draws (two per block) are far from all-keep."""
    grads, metrics = [], []
    for use_checkpoint in (False, True):
        jcfg = _swin_cfg(use_checkpoint)
        cfg = port_config(jcfg)
        model = _port_model(jcfg, weights["variables"])
        blocks = [m for m in model.backbone.modules()
                  if isinstance(m, backbone_video_swin.SwinBlock3D)]
        for blk in blocks:
            blk.drop_path.p = 0.5
        step = make_train_step(model, criterion_config(cfg), build_weight_dict(cfg),
                               build_optimizer(model, cfg))
        metrics.append(step(weights["batch"]))
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()
                      if p.grad is not None})
    assert metrics[0]["loss"] == pytest.approx(metrics[1]["loss"], rel=1e-6)
    assert grads[0].keys() == grads[1].keys()
    for k, g in grads[0].items():
        scale = max(g.abs().max().item(), 1e-6)
        err = (grads[1][k] - g).abs().max().item()
        assert err <= 1e-6 * scale, (k, err, scale)


# ----------------------------------------------------------- param groups --
@pytest.mark.parametrize("freeze", [False, True])
def test_swin_param_groups_match_jax(freeze):
    jcfg = _jax_cfg("davis").replace(backbone="video_swin_test", freeze_video_encoder=freeze)
    jmodel, *_ = jax_build_model(jcfg)
    variables = random_variables(jmodel, seed=0)
    cfg = port_config(jcfg)
    names = dict(build_model(cfg, device="cpu").named_parameters())
    seen = {}
    for path, arr in _flatten(variables["params"]):
        key, _ = _port_key(path, arr)
        assert key in names, key
        label = jax_param_group_label(jcfg, path)
        assert param_group_label(cfg, key) == label, key
        if key.startswith("backbone."):
            seen[label] = seen.get(label, 0) + 1
    # every backbone leaf of a Swin trains unless the video encoder is frozen
    assert list(seen) == ["frozen" if freeze else "backbone"]
