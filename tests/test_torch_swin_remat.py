"""The port's Swin train step with per-block recompute (``use_checkpoint``:
the port's ``torch.utils.checkpoint``, JAX's ``nn.remat``) against the JAX
step on the CPU, at the bounds of tests/test_torch_swin_train.py (which
holds the step without recompute; this file is apart to keep each file's
time short).

The 2D Swin-L of the benchmark's ``ocpg_swinl_ytvos`` (embed 192, heads
6/12/24/48 of 32 channels, window 7x7, each block recomputed) is held the
same way and at the same bounds, with its depths cut to 2 a stage so that
every stage has a shifted block, behind the tiny transformer and text
encoder (measured in float32: losses 8e-7, ``grad_norm`` 5e-6, the worst
leaf 6e-6 of its max |g|).  The same step with the port computing in
bfloat16 must break at least one bound (it reads 1.5e-4, 7.9e-3 and 0.54):
a bound that one precision down still meets would not show a lost part of
the mathematics.
"""
import dataclasses

import numpy as np
import pytest

import jax
import optax

from ocpg_tpu.models import backbone_swin2d as jax_swin2d
from ocpg_tpu.models import build_model as jax_build_model

from ocpg_tpu_torch.engine.optim import build_optimizer
from ocpg_tpu_torch.engine.train import make_train_step
from ocpg_tpu_torch.models import backbone_swin2d
from ocpg_tpu_torch.models.build import build_model, build_weight_dict, criterion_config
from ocpg_tpu_torch.utils.weights import jax_to_state_dict, load_jax_params

from tests.test_torch_model import _jax_cfg, port_config
from tests.test_torch_swin_train import _jax_step, _swin_cfg, check_swin_train_step
from tests.test_torch_train_model import (GRAD_ATOL, LOSS_RTOL, NORM_RTOL, _batch,
                                          _train_variables)
from tests.torch_threads import one_torch_thread  # noqa: F401

# Swin-L's widths (swin_l_p4w7) with its depths (2, 2, 18, 2) cut
SWIN_L_CUT = dict(embed_dim=192, depths=(2, 2, 2, 2), num_heads=(6, 12, 24, 48))


@pytest.fixture(scope="module")
def weights():
    jmodel, *_ = jax_build_model(_swin_cfg(use_checkpoint=True))
    batch = _batch(seed=6)
    return dict(batch=batch, variables=_train_variables(jmodel, batch, seed=8))


def test_swin_train_step_with_recompute_matches_jax(weights):
    check_swin_train_step(weights, use_checkpoint=True)


@pytest.fixture(scope="module")
def swin_l():
    """The JAX config of the cut Swin-L with recompute (entered as
    ``swin_l_p4w7`` in both packages' tables), its weights, a batch, and the
    JAX loss, losses and gradients of one deterministic step."""
    with pytest.MonkeyPatch.context() as mp:
        for configs in (jax_swin2d._CONFIGS, backbone_swin2d._CONFIGS):
            mp.setitem(configs, "swin_l_p4w7", SWIN_L_CUT)
        jcfg = _jax_cfg("ytvos").replace(backbone="swin_l_p4w7", use_checkpoint=True)
        jmodel, *_ = jax_build_model(jcfg)
        batch = _batch(seed=6)
        variables = _train_variables(jmodel, batch, seed=8)
        total, losses, grads = _jax_step(jcfg, variables, batch)
        yield dict(jcfg=jcfg, batch=batch, variables=variables, total=total, losses=losses,
                   grads=grads)


def _swin_l_step_gaps(swin_l, compute_dtype):
    """The port's deterministic step, computing in ``compute_dtype``, against
    the JAX step: the worst loss's relative gap, ``grad_norm``'s relative
    gap, and the worst leaf's gradient gap over that leaf's max |g|."""
    cfg = dataclasses.replace(port_config(swin_l["jcfg"]), compute_dtype=compute_dtype)
    model = build_model(cfg, device="cpu")
    assert model.backbone.use_checkpoint and model.backbone.embed_dim == 192
    assert load_jax_params(model, swin_l["variables"]) == []
    step = make_train_step(model, criterion_config(cfg), build_weight_dict(cfg),
                           build_optimizer(model, cfg), deterministic=True)
    metrics = step(swin_l["batch"])
    assert metrics["finite"] == 1.0
    losses = dict(swin_l["losses"], loss=swin_l["total"])
    loss_gap = max(abs(metrics[k] - v) / max(abs(v), 1e-6) for k, v in losses.items())
    grads = swin_l["grads"]
    jax_norm = float(optax.global_norm(jax.tree_util.tree_leaves(grads)))
    clip = min(1.0, cfg.clip_max_norm / jax_norm)
    params = dict(model.named_parameters())
    want = jax_to_state_dict({"params": grads})
    assert any(k.startswith("backbone.stage3_block1.") for k in want)
    grad_gap = 0.0
    for name, g in want.items():
        p = params[name]
        got = np.zeros_like(g) if p.grad is None else p.grad.float().numpy()
        scale = max(np.abs(g * clip).max(), 1e-6)
        grad_gap = max(grad_gap, float(np.abs(got - g * clip).max() / scale))
    return loss_gap, abs(metrics["grad_norm"] - jax_norm) / jax_norm, grad_gap


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_swin_l_train_step_with_recompute_matches_jax(swin_l, compute_dtype):
    """float32 within every bound; bfloat16 (the control) outside one at least."""
    loss_gap, norm_gap, grad_gap = _swin_l_step_gaps(swin_l, compute_dtype)
    within = loss_gap <= LOSS_RTOL and norm_gap <= NORM_RTOL and grad_gap <= GRAD_ATOL
    assert within == (compute_dtype == "float32"), (loss_gap, norm_gap, grad_gap)
