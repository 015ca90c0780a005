"""The port's train-step pieces against the JAX package, on the CPU:
box utilities, the matcher, the loss suite, the optimizer chain and the
parameter groups; the dropout helper; and a short overfit of the port.

Inputs come from numpy seeds and go through both packages in float32.
Tolerances: box utilities and losses at 1e-5 relative (float32 sums in
another order); the matcher's indices identical, on inputs whose costs are
far from ties; the optimizer's parameters and first moments at 1e-6 (the
same AdamW arithmetic, rounded in another order).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from ocpg_tpu.config import OCPGConfig as JaxConfig
from ocpg_tpu.engine.optim import build_optimizer as jax_build_optimizer
from ocpg_tpu.engine.optim import param_group_label as jax_param_group_label
from ocpg_tpu.models import build_model as jax_build_model
from ocpg_tpu.models import criterion as j_crit
from ocpg_tpu.models.matcher import MatcherConfig as JaxMatcherConfig
from ocpg_tpu.models.matcher import match as jax_match
from ocpg_tpu.utils import box_ops as j_box

from ocpg_tpu_torch.config import OCPGConfig
from ocpg_tpu_torch.data.synthetic import synthetic_batch
from ocpg_tpu_torch.engine.optim import TrainOptimizer, build_optimizer, param_group_label
from ocpg_tpu_torch.engine.train import make_train_step
from ocpg_tpu_torch.models import criterion as p_crit
from ocpg_tpu_torch.models.build import (build_model, build_weight_dict, criterion_config,
                                         matcher_config)
from ocpg_tpu_torch.models.layers import Dropout
from ocpg_tpu_torch.models.matcher import MatcherConfig, match
from ocpg_tpu_torch.utils import box_ops as p_box
from ocpg_tpu_torch.utils.weights import _flatten, _port_key

from tests.test_torch_model import _jax_cfg, port_config, random_variables

RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _boxes(rng, *shape):
    """cxcywh boxes inside the unit square."""
    c = rng.uniform(0.25, 0.75, (*shape, 2))
    wh = rng.uniform(0.05, 0.4, (*shape, 2))
    return np.concatenate([c, wh], -1).astype(np.float32)


# --------------------------------------------------------------- box_ops --
def test_box_ops_match_jax():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 6, 3), _boxes(rng, 6, 3)
    np.testing.assert_allclose(p_box.box_cxcywh_to_xyxy(_t(a)).numpy(),
                               j_box.box_cxcywh_to_xyxy(jnp.asarray(a)), rtol=RTOL)
    xa, xb = (np.asarray(j_box.box_cxcywh_to_xyxy(jnp.asarray(v))) for v in (a, b))
    np.testing.assert_allclose(p_box.box_area(_t(xa)).numpy(), j_box.box_area(xa), rtol=RTOL)
    np.testing.assert_allclose(p_box.generalized_box_iou_aligned(_t(xa), _t(xb)).numpy(),
                               j_box.generalized_box_iou_aligned(xa, xb), rtol=RTOL,
                               atol=1e-6)


# --------------------------------------------------------------- matcher --
@pytest.mark.parametrize("num_classes", [1, 3])
def test_match_matches_jax(num_classes):
    rng = np.random.default_rng(1 + num_classes)
    b, t, q, h, w = 6, 3, 5, 16, 24
    logits = rng.standard_normal((b, t, q, num_classes)).astype(np.float32) * 2
    boxes = _boxes(rng, b, t, q)
    masks = rng.standard_normal((b, t, q, h // 2, w // 2)).astype(np.float32) * 3
    labels = rng.integers(0, num_classes, (b, t)).astype(np.int32)
    tboxes = _boxes(rng, b, t)
    tmasks = (rng.random((b, t, h, w)) > 0.6).astype(np.float32)
    valid = np.ones((b, t), np.int32)
    valid[1, 0] = valid[3, 2] = 0
    args = (logits, boxes, masks, labels, tboxes, tmasks, valid)
    jcfg = JaxMatcherConfig(num_classes=num_classes)
    want = np.asarray(jax_match(jcfg, *map(jnp.asarray, args)))
    got = match(MatcherConfig(num_classes=num_classes), *map(_t, args)).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(set(want.tolist())) > 1           # the inputs pick different queries


def test_matcher_config_from_model_config():
    cfg = OCPGConfig(set_cost_bbox=3.0)
    m = matcher_config(cfg)
    assert (m.cost_class, m.cost_bbox, m.cost_giou, m.cost_mask, m.cost_dice) == (
        2.0, 3.0, 2.0, 2.0, 5.0)


# ------------------------------------------------------------- criterion --
def _criterion_inputs(seed):
    rng = np.random.default_rng(seed)
    ldec, b, t, q, h, w = 2, 2, 3, 5, 32, 40
    outputs = {
        "outputs_class": rng.standard_normal((ldec, b, t, q, 1)).astype(np.float32),
        "outputs_coord": _boxes(rng, ldec, b, t, q),
        "matched": rng.integers(0, q, (ldec, b)).astype(np.int32),
        "pred_masks_layers": (rng.standard_normal((ldec, b, t, h, w)) * 3).astype(np.float32),
        "pred_masks_low_layers": (rng.standard_normal((ldec, b, t, h // 2, w // 2)) * 3
                                  ).astype(np.float32),
        "ls_features": rng.standard_normal((b, t, h // 2, w // 2, 12)).astype(np.float32),
    }
    heat = rng.random((b, t, h, w)).astype(np.float32)
    targets = {
        "labels": np.zeros((b, t), np.int32),
        "boxes": _boxes(rng, b, t),
        "valid": np.asarray([[1, 0, 1], [1, 1, 0]], np.int32),   # some frames not valid
        "masks": (heat > 0.6).astype(np.float32),
        "weights": heat,
        "weak_masks": (heat > 0.5).astype(np.float32),
        "size": np.asarray([[h, w - 8], [h - 4, w]], np.int32),
    }
    return outputs, targets


@pytest.mark.parametrize("step", [0, 50_000, 250_000])
def test_compute_criterion_matches_jax(step):
    """At step 0 (CE only), mid-warmup and after it (level set only)."""
    outputs, targets = _criterion_inputs(seed=step % 7)
    jcfg = JaxConfig(dec_layers=2)
    weight_dict = build_weight_dict(port_config(jcfg))
    _, _, jax_crit_cfg, jax_weights = jax_build_model(jcfg)
    assert weight_dict == jax_weights
    j_total, j_losses = jax.jit(
        lambda o, tg: j_crit.compute_criterion(jax_crit_cfg, jax_weights, o, tg,
                                               jnp.asarray(step)))(
        jax.tree_util.tree_map(jnp.asarray, outputs),
        jax.tree_util.tree_map(jnp.asarray, targets))
    p_outputs = {k: _t(v) for k, v in outputs.items()}
    p_outputs["matched"] = p_outputs["matched"].long()
    total, losses = p_crit.compute_criterion(criterion_config(port_config(jcfg)),
                                             weight_dict, p_outputs,
                                             {k: _t(v) for k, v in targets.items()}, step)
    assert set(losses) == set(j_losses)
    for k, v in losses.items():
        np.testing.assert_allclose(float(v), float(j_losses[k]), rtol=RTOL, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(float(total), float(j_total), rtol=RTOL)
    warm = min(step / 100_000, 1.0)
    assert (float(losses["loss_mask"]) == 0.0) == (warm == 1.0)
    assert (float(losses["loss_lst"]) == 0.0) == (warm == 0.0)


def test_criterion_refuses_the_pairwise_loss():
    outputs, targets = _criterion_inputs(seed=1)
    cfg = criterion_config(OCPGConfig(pairwise_loss=True))
    with pytest.raises(NotImplementedError, match="pairwise"):
        p_crit.compute_criterion(cfg, {}, {k: _t(v) for k, v in outputs.items()},
                                 {k: _t(v) for k, v in targets.items()}, 0)


# ------------------------------------------------------------- optimizer --
OPT_TREE = {   # a leaf per parameter group (frozen included), flax-style paths
    "backbone": {"conv1": {"kernel": (3, 4)}, "layer2_0": {"conv1": {"kernel": (4, 5)}}},
    "text_encoder": {"layer_0": {"q": {"kernel": (5, 3)}}},
    "transformer": {"reference_points": {"kernel": (4, 2), "bias": (2,)}},
    "controller": {"layers_0": {"kernel": (6, 3), "bias": (3,)}},
}


def test_optimizer_matches_optax_chain():
    """Four steps across an LR boundary, the third skipped (non-finite), the
    clip active (grad norms ~ 4 against clip_max_norm 0.1) and a frozen
    group (the ResNet stem and the text encoder) whose grads enter the norm."""
    cfg = OCPGConfig(backbone="resnet101", lr=1e-3, lr_backbone=5e-4, weight_decay=1e-2)
    jcfg = JaxConfig(backbone="resnet101", lr=1e-3, lr_backbone=5e-4, weight_decay=1e-2)
    rng = np.random.default_rng(3)
    leaves = [(p, s) for p, s in _flatten_shapes(OPT_TREE)]
    init = {p: rng.standard_normal(s).astype(np.float32) for p, s in leaves}
    grads = [{p: (rng.standard_normal(s) * 2).astype(np.float32) for p, s in leaves}
             for _ in range(4)]
    applied = [True, True, False, True]

    tx = jax_build_optimizer(jcfg, lr_drop_steps=[2])
    jparams = _nest({p: jnp.asarray(v) for p, v in init.items()})
    jstate = tx.init(jparams)
    named = [(".".join(p), torch.nn.Parameter(_t(v.copy()))) for p, v in init.items()]
    opt = TrainOptimizer(named, cfg, lr_drop_steps=[2])
    assert {g["label"] for g in opt.adamw.param_groups} == {"main", "backbone", "proj"}
    for g_np, ok in zip(grads, applied):
        updates, new_state = tx.update(_nest({p: jnp.asarray(v) for p, v in g_np.items()}),
                                       jstate, jparams)
        if ok:
            jparams, jstate = optax.apply_updates(jparams, updates), new_state
        for (name, p), path in zip(named, init):
            p.grad = _t(g_np[path].copy())
        norm = float(opt.clip_grads_())
        want_norm = float(optax.global_norm(list(g_np.values())))
        np.testing.assert_allclose(norm, want_norm, rtol=1e-6)
        if ok:
            opt.step()
        flat = dict(_flatten(jax.tree_util.tree_map(np.asarray, jparams)))
        for (name, p), path in zip(named, init):
            np.testing.assert_allclose(p.detach().numpy(), flat[path], rtol=1e-6, atol=1e-6,
                                       err_msg=name)
    assert opt.count == 3
    # the frozen leaves never moved
    for (name, p), path in zip(named, init):
        if jax_param_group_label(jcfg, path) == "frozen":
            np.testing.assert_array_equal(p.detach().numpy(), init[path])
    # the last lr is past the boundary
    assert {g["label"]: g["lr"] for g in opt.adamw.param_groups}["main"] == pytest.approx(1e-4)


def _flatten_shapes(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten_shapes(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def test_param_groups_match_jax():
    """param_group_label over the port's parameter names gives the JAX
    label of the same leaf of the flax tree."""
    jcfg = _jax_cfg("davis")
    jmodel, *_ = jax_build_model(jcfg)
    variables = random_variables(jmodel, seed=0)
    cfg = port_config(jcfg)
    model = build_model(cfg, device="cpu")
    port_names = dict(model.named_parameters())
    seen = set()
    for path, arr in _flatten(variables["params"]):
        key, _ = _port_key(path, arr)
        assert key in port_names, key
        assert param_group_label(cfg, key) == jax_param_group_label(jcfg, path), key
        seen.add(jax_param_group_label(jcfg, path))
    assert seen == {"main", "backbone", "proj", "frozen"}
    opt = build_optimizer(model, cfg)
    n_trained = sum(len(g["params"]) for g in opt.adamw.param_groups)
    n_frozen = sum(param_group_label(cfg, k) == "frozen" for k in port_names)
    assert n_trained + n_frozen == len(port_names) == len(opt.params)


# --------------------------------------------------------------- dropout --
def test_dropout_helper():
    p = 0.25
    x = torch.ones(200_000)
    drop = Dropout(p)
    drop.generator = torch.Generator().manual_seed(5)
    y = drop(x)
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - p)) < 5e-3         # keep rate
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / (1 - p)))  # 1/(1-p) scale
    drop.generator = torch.Generator().manual_seed(5)
    assert torch.equal(drop(x), y)                                   # same seed, same mask
    assert not torch.equal(drop(x), y)                               # the stream moves on
    assert torch.equal(drop.eval()(x), x)                            # off in eval mode
    assert torch.equal(Dropout(0.0).train()(x), x)


def test_model_dropout_draws_from_the_step_generator():
    """make_train_step hands every dropout of the model one generator,
    seeded from cfg.seed; in training mode the same seed gives the same
    train forward, and eval mode turns dropout off."""
    cfg = port_config(_jax_cfg("ytvos"))
    batch = synthetic_batch(np.random.default_rng(0), batch=1, frames=2, height=64,
                            width=64, text_len=8, vocab_size=1000)
    model = build_model(cfg, device="cpu")
    make_train_step(model, criterion_config(cfg), build_weight_dict(cfg),
                    build_optimizer(model, cfg))
    drops = [m for m in model.modules() if isinstance(m, Dropout) and m.p > 0]
    gen = drops[0].generator
    assert gen is not None and all(m.generator is gen for m in drops)
    args = [_t(batch[k]) for k in ("samples", "samples_mask", "text_ids", "text_mask")]
    targets = {k: _t(v) for k, v in batch["targets"].items()}

    def masks():
        with torch.no_grad():
            return model(*args, _t(batch["targets"]["size"]), targets=targets,
                         train=True)["pred_masks_layers"]

    model.train()
    runs = []
    for _ in range(2):
        gen.manual_seed(cfg.seed)
        runs.append(masks())
    assert torch.equal(runs[0], runs[1])
    model.eval()
    assert not torch.equal(masks(), runs[0])


# --------------------------------------------------------------- overfit --
def test_port_overfits_one_batch():
    """About 30 steps on one fixed batch (visible objects, dropout off): the
    loss falls below half its start.  The settings of
    tests/test_convergence.py (clip 10, level-set warmup 40) with the lr at
    2e-4 for 30 steps of a 2-clip batch."""
    cfg = OCPGConfig(backbone="resnet50", enc_layers=1, dec_layers=2, dim_feedforward=64,
                     num_queries=5, num_frames=2, compute_dtype="float32",
                     dataset_file="ytvos", text_layers=2, text_hidden=128, text_heads=4,
                     text_ffn=256, text_vocab=2048, lr=2e-4, lr_backbone=2e-4,
                     lr_linear_proj_mult=0.2, clip_max_norm=10.0, lst_warmup_iters=40)
    model = build_model(cfg, device="cpu")
    step = make_train_step(model, criterion_config(cfg), build_weight_dict(cfg),
                           build_optimizer(model, cfg), deterministic=True)
    batch = synthetic_batch(np.random.default_rng(7), batch=2, frames=2, height=64,
                            width=64, text_len=8, vocab_size=2048, visible_objects=True)
    losses = [step(batch)["loss"] for _ in range(30)]
    assert all(np.isfinite(losses)), losses
    assert np.mean(losses[-3:]) < 0.5 * losses[0], losses
