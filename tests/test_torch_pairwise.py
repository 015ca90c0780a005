"""The port's BoxInst pairwise loss (``models/pairwise.py``) and the
criterion with ``pairwise=True`` against the JAX package, on the CPU, in
float32, within 1e-5 (relative, and absolute on the scale of each output's
max |.|: the same float32 arithmetic in another order).

The frames are smooth color fields (a few Gaussian blobs over a gradient),
so that neighbouring pixels are alike and both similarity gates
(>= 0.05) pass for part of the pixels: on pure noise the temporal term's
27-channel patch distances are large everywhere and its weights all 0.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ocpg_tpu.config import OCPGConfig as JaxConfig
from ocpg_tpu.models import build_model as jax_build_model
from ocpg_tpu.models import criterion as j_crit
from ocpg_tpu.models import pairwise as jp

from ocpg_tpu_torch.models import criterion as p_crit
from ocpg_tpu_torch.models import pairwise as pp
from ocpg_tpu_torch.models.build import build_weight_dict, criterion_config

from tests.test_torch_model import port_config
from tests.test_torch_train import _criterion_inputs
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5


def _close(got, want, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale, err_msg=name)


def smooth_frames(rng, b, t, h, w):
    """ImageNet-normalised RGB (B, T, H, W, 3): a color gradient plus three
    Gaussian blobs per clip, drifting over the frames."""
    yy, xx = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    out = np.zeros((b, t, h, w, 3), np.float32)
    for i in range(b):
        base = rng.uniform(-1, 1, (3, 3))
        blobs = rng.uniform(0.2, 0.8, (3, 2)), rng.uniform(-2, 2, (3, 3))
        for j in range(t):
            img = base[0] + base[1] * xx[..., None] + base[2] * yy[..., None]
            for (cy, cx), col in zip(*blobs):
                g = np.exp(-((yy - cy) ** 2 + (xx - cx - 0.03 * j) ** 2) / 0.02)
                img = img + g[..., None] * col
            out[i, j] = img
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def maps():
    rng = np.random.default_rng(0)
    b, c, h, w = 2, 3, 12, 15
    return dict(x=rng.standard_normal((b, c, h, w)).astype(np.float32),
                y=rng.standard_normal((b, c, h, w)).astype(np.float32),
                logits=(rng.standard_normal((b, 1, h, w)) * 3).astype(np.float32),
                logits_n=(rng.standard_normal((b, 1, h, w)) * 3).astype(np.float32),
                lab=np.moveaxis(np.asarray(jp.normalized_rgb_to_lab(
                    jnp.asarray(smooth_frames(rng, 1, b, h, w)[0]))), -1, 1))


@pytest.mark.parametrize("k,d", [(3, 1), (3, 2), (5, 3)])
def test_unfold_matches_jax(maps, k, d):
    for fn in ("unfold_w_center", "unfold_wo_center"):
        _close(getattr(pp, fn)(_t(maps["x"]), k, d),
               getattr(jp, fn)(jnp.asarray(maps["x"]), k, d), fn)


def test_pairwise_terms_match_jax(maps):
    lg, ln = maps["logits"], maps["logits_n"]
    _close(pp.compute_pairwise_term(_t(lg), 3, 2),
           jp.compute_pairwise_term(jnp.asarray(lg), 3, 2), "spatial")
    _close(pp.compute_pairwise_term_neighbor(_t(lg), _t(ln), 3, 3),
           jp.compute_pairwise_term_neighbor(jnp.asarray(lg), jnp.asarray(ln), 3, 3),
           "neighbor")


@pytest.mark.parametrize("src", ["noise", "lab"])
def test_color_similarities_match_jax(maps, src):
    a = maps["x"] if src == "noise" else maps["lab"]
    b = maps["y"] if src == "noise" else maps["lab"][::-1].copy()
    _close(pp.get_images_color_similarity(_t(a), 3, 2),
           jp.get_images_color_similarity(jnp.asarray(a), 3, 2), "images")
    _close(pp.get_neighbor_images_color_similarity(_t(a), _t(b), 3, 3),
           jp.get_neighbor_images_color_similarity(jnp.asarray(a), jnp.asarray(b), 3, 3),
           "neighbor")
    got = pp.get_neighbor_images_patch_color_similarity(_t(a), _t(b), 3, 3)
    _close(got, jp.get_neighbor_images_patch_color_similarity(
        jnp.asarray(a), jnp.asarray(b), 3, 3), "patch")
    if src == "lab":
        assert 0.0 < float((got >= 0.05).float().mean()) < 1.0    # the gate splits


def test_color_space_matches_jax():
    rng = np.random.default_rng(1)
    rgb = rng.uniform(0, 1, (4, 6, 3)).astype(np.float32)
    rgb[0, :3] = [[0, 0, 0], [1, 1, 1], [0.04, 0.04045, 0.05]]     # the spline's edges
    _close(pp.rgb2lab(_t(rgb)), jp.rgb2lab(jnp.asarray(rgb)), "rgb2lab")
    img = smooth_frames(rng, 2, 3, 8, 10)
    img[0, 0, 0, :2] = [[9.0, 9.0, 9.0], [-9.0, -9.0, -9.0]]       # clipped to 0..255
    _close(pp.normalized_rgb_to_lab(_t(img)), jp.normalized_rgb_to_lab(jnp.asarray(img)),
           "normalized_rgb_to_lab")


@pytest.mark.parametrize("t", [2, 3, 7])
def test_pairwise_losses_match_jax(t):
    """T = 2 (no temporal term), 3 (one triplet) and 7 (two triplets and a
    frame left over)."""
    rng = np.random.default_rng(t)
    b, h, w = 2, 16, 20
    logits = (rng.standard_normal((b, t, h, w)) * 3).astype(np.float32)
    img = smooth_frames(rng, b, t, h, w)
    region = np.zeros((b, t, h, w), np.float32)
    region[:, :, 3:13, 4:15] = 1.0
    region[1, 0] = 0.0
    want = jp.pairwise_losses(jnp.asarray(logits), jnp.asarray(img), jnp.asarray(region))
    got = pp.pairwise_losses(_t(logits), _t(img), _t(region))
    assert set(got) == set(want) == {"loss_pairwise", "loss_pairwise_neighbor"}
    for k in want:
        _close(got[k], want[k], k)
    assert float(got["loss_pairwise"]) > 0
    assert (float(got["loss_pairwise_neighbor"]) > 0) == (t >= 3)


def test_criterion_with_pairwise_matches_jax():
    outputs, targets = _criterion_inputs(seed=2)
    b, t, h2, w2, _ = outputs["ls_features"].shape
    outputs["ls_features"][..., :3] = smooth_frames(np.random.default_rng(4), b, t, h2, w2)
    jcfg = JaxConfig(dec_layers=2, pairwise_loss=True)
    cfg = port_config(jcfg)
    weight_dict = build_weight_dict(cfg)
    _, _, jax_crit_cfg, jax_weights = jax_build_model(jcfg)
    assert weight_dict == jax_weights and jax_crit_cfg.pairwise
    j_total, j_losses = jax.jit(
        lambda o, tg: j_crit.compute_criterion(jax_crit_cfg, jax_weights, o, tg,
                                               jnp.asarray(0)))(
        jax.tree_util.tree_map(jnp.asarray, outputs),
        jax.tree_util.tree_map(jnp.asarray, targets))
    p_outputs = {k: _t(v) for k, v in outputs.items()}
    p_outputs["matched"] = p_outputs["matched"].long()
    total, losses = p_crit.compute_criterion(criterion_config(cfg), weight_dict, p_outputs,
                                             {k: _t(v) for k, v in targets.items()}, 0)
    assert set(losses) == set(j_losses)
    assert {"loss_pairwise", "loss_pairwise_neighbor", "loss_pairwise_0"} <= set(losses)
    for k, v in losses.items():
        np.testing.assert_allclose(float(v), float(j_losses[k]), rtol=TOL, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(float(total), float(j_total), rtol=TOL)
    assert float(losses["loss_pairwise_neighbor"]) > 0
