"""The port's standard-layout MSDA op (``ms_deform_attn_fast``, its backward,
the plain gather and separable versions and the layout conversions in
``ocpg_tpu_torch/ops/ms_deform_attn.py``) against the JAX package's, on the
CPU.

* The plain forward against the JAX float32 gather path ``ms_deform_attn``
  at rtol/atol 1e-5, with samples outside the map and on exactly-integer
  pixel coordinates, and against the interpreted Pallas kernel
  ``ms_deform_attn_pallas`` (K3) at 2e-2: it rounds the value and its hat
  rows to bfloat16.
* The plain backward against ``jax.grad`` of the gather path at 1e-4,
  including the right-sided derivative at xp = -1 and at integer xp, and
  against the interpreted Pallas backward ``ms_deform_attn_pallas_bwd`` (K4)
  at 6e-3 of each gradient's max (the bound of
  tests/test_ms_deform_attn_pallas.py); zero coordinate and weight
  gradients at non-finite coordinates; ``gradcheck`` in float64.
* The plain separable version against JAX ``ms_deform_attn_separable`` at
  1e-5, forward and gradients.
* The layout conversions against JAX ``_cm_to_standard``, and their round
  trip, exactly.
* The dispatcher: CPU tensors take the plain version and launch nothing; a
  device with no path and malformed inputs raise.

The CUDA kernels themselves are held against the plain versions on the
card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ocpg_tpu.ops.ms_deform_attn import (_cm_to_standard as jax_cm_to_standard,
                                         ms_deform_attn, ms_deform_attn_separable)
from ocpg_tpu.ops.ms_deform_attn_pallas import (ms_deform_attn_pallas,
                                                 ms_deform_attn_pallas_bwd)

from ocpg_tpu_torch.ops import ms_deform_attn as port_msda
from ocpg_tpu_torch.ops.ms_deform_attn import (_cm_to_standard, _standard_to_cm,
                                                ms_deform_attn_backward,
                                                ms_deform_attn_fast,
                                                ms_deform_attn_reference)

LEVEL_SETS = {
    "two_levels": ((6, 4), (3, 2)),
    "four_levels_to_1x1": ((8, 10), (4, 5), (2, 3), (1, 1)),
}
# power-of-two sizes: x * W is exact in float32 whatever the multiply-add
# contraction, so both packages see the same exactly-integer coordinates
POW2_LEVELS = ((8, 4), (4, 2), (2, 1))


def _inputs(shapes, seed, n=2, m=4, d=8, lq=6, p=3, integer_coords=False):
    """value (N, S, M, D); locs (N, Lq, M, L, P, 2) in [-0.1, 1.1] (some
    samples outside the map); attn (N, Lq, M, L, P) normalised over (L, P)."""
    rng = np.random.default_rng(seed)
    l = len(shapes)
    s = sum(h * w for h, w in shapes)
    value = rng.standard_normal((n, s, m, d)).astype(np.float32)
    locs = (rng.random((n, lq, m, l, p, 2)) * 1.2 - 0.1).astype(np.float32)
    attn = rng.random((n, lq, m, l, p)).astype(np.float32)
    attn /= attn.sum(axis=(3, 4), keepdims=True)
    if integer_coords:
        # (k + 0.5) / W lands exactly on pixel k in float32 (and k = -1, W
        # on the first corner outside the map)
        for lid, (h, w) in enumerate(shapes):
            kx = rng.integers(-1, w + 1, (n, lq, m, p))
            ky = rng.integers(-1, h + 1, (n, lq, m, p))
            locs[:, :, :, lid, :, 0] = ((kx + 0.5) / w).astype(np.float32)
            half = p // 2 + 1
            locs[:, :, :, lid, :half, 1] = ((ky + 0.5) / h).astype(np.float32)[..., :half]
    return value, locs, attn


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _cotangent(value, locs, seed):
    n, _, m, d = value.shape
    return np.random.default_rng(seed).standard_normal((n, locs.shape[1], m * d)).astype(
        np.float32)


@pytest.mark.parametrize("integer_coords", [False, True])
@pytest.mark.parametrize("levels", sorted(LEVEL_SETS))
def test_plain_matches_jax_gather(levels, integer_coords):
    shapes = LEVEL_SETS[levels]
    value, locs, attn = _inputs(shapes, seed=1, integer_coords=integer_coords)
    want = np.asarray(ms_deform_attn(*map(jnp.asarray, (value,)), shapes,
                                     jnp.asarray(locs), jnp.asarray(attn)))
    v, lc, at = _t(value, locs, attn)
    got = ms_deform_attn_reference(v, shapes, lc, at).numpy()
    assert got.shape == (value.shape[0], locs.shape[1], value.shape[2] * value.shape[3])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_plain_matches_interpreted_pallas_kernel():
    shapes = LEVEL_SETS["two_levels"]
    value, locs, attn = _inputs(shapes, seed=2)
    want = np.asarray(ms_deform_attn_pallas(jnp.asarray(value), shapes, jnp.asarray(locs),
                                            jnp.asarray(attn), 128, True))
    v, lc, at = _t(value, locs, attn)
    np.testing.assert_allclose(ms_deform_attn_reference(v, shapes, lc, at).numpy(), want,
                               rtol=2e-2, atol=2e-2)


def _jax_grads(value, shapes, locs, attn, g):
    def loss(v, lc, at):
        return (ms_deform_attn(v, shapes, lc, at) * g).sum()

    grads = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (value, locs, attn)))
    return [np.asarray(a) for a in grads]


def _port_grads(value, shapes, locs, attn, g):
    v, lc, at, gg = _t(value, locs, attn, g)
    return [t.numpy() for t in ms_deform_attn_backward(v, shapes, lc, at, gg)]


@pytest.mark.parametrize("levels,integer_coords", [
    ("two_levels", False), ("four_levels_to_1x1", False), ("pow2", False), ("pow2", True)])
def test_plain_backward_matches_jax_gather_grad(levels, integer_coords):
    """Exact pixel coordinates only on power-of-two level sizes (POW2_LEVELS)."""
    shapes = POW2_LEVELS if levels == "pow2" else LEVEL_SETS[levels]
    value, locs, attn = _inputs(shapes, seed=11, integer_coords=integer_coords)
    g = _cotangent(value, locs, seed=12)
    for name, got, want in zip(("d_value", "d_locs", "d_attn"),
                               _port_grads(value, shapes, locs, attn, g),
                               _jax_grads(value, shapes, locs, attn, g)):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=name)


def test_plain_backward_is_right_sided_at_xp_minus_one():
    """x = -0.5 / W puts xp at exactly -1: the forward is 0 there, the
    right-sided derivative is aw * v[., 0] * W, as the JAX gather autodiff."""
    shapes = POW2_LEVELS
    value, locs, attn = _inputs(shapes, seed=13)
    for lid, (h, w) in enumerate(shapes):
        locs[:, :, :, lid, 0, 0] = -0.5 / w
    g = _cotangent(value, locs, seed=14)
    got = _port_grads(value, shapes, locs, attn, g)
    want = _jax_grads(value, shapes, locs, attn, g)
    assert np.abs(want[1][:, :, :, :, 0, 0]).max() > 0.1     # the derivative is not 0
    for name, a, b in zip(("d_value", "d_locs", "d_attn"), got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=name)


def test_plain_backward_matches_interpreted_pallas_kernel():
    shapes = LEVEL_SETS["two_levels"]
    value, locs, attn = _inputs(shapes, seed=15)
    g = _cotangent(value, locs, seed=16)
    want = ms_deform_attn_pallas_bwd(*map(jnp.asarray, (value,)), shapes,
                                     *map(jnp.asarray, (locs, attn, g)), 128, True)
    for name, got, ref in zip(("d_value", "d_locs", "d_attn"),
                              _port_grads(value, shapes, locs, attn, g), want):
        ref = np.asarray(ref, np.float32)
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got / scale, ref / scale, atol=6e-3, err_msg=name)


def test_non_finite_coordinates_sample_nothing_and_get_zero_gradients():
    """A wholly padded frame has valid ratio 0 and NaN reference points; the
    JAX gather path gives 0 for such samples, and the port's gradients of
    their coordinates and weights are 0."""
    shapes = LEVEL_SETS["two_levels"]
    value, locs, attn = _inputs(shapes, seed=17)
    locs[0, 0, :, :, :, 0] = np.nan
    locs[1, 2, :, 1, :, 1] = np.inf
    want = np.asarray(ms_deform_attn(jnp.asarray(value), shapes, jnp.asarray(locs),
                                     jnp.asarray(attn)))
    v, lc, at = _t(value, locs, attn)
    got = ms_deform_attn_reference(v, shapes, lc, at).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    d_value, d_locs, d_attn = _port_grads(value, shapes, locs, attn,
                                          _cotangent(value, locs, seed=18))
    assert np.isfinite(d_value).all()
    for grad in (d_locs, d_attn):
        assert np.isfinite(grad).all() and np.abs(grad).max() > 0
        assert (grad[0, 0] == 0).all() and (grad[1, 2, :, 1] == 0).all()


def test_plain_version_gradcheck_float64():
    """Away from the kinks (coordinates off the pixel grid and the borders)."""
    shapes = ((3, 4), (2, 2))
    rng = np.random.default_rng(19)
    n, m, d, p, lq = 1, 2, 3, 2, 3
    value = torch.from_numpy(rng.standard_normal((n, 16, m, d)))
    locs = torch.from_numpy(rng.uniform(0.15, 0.85, (n, lq, m, 2, p, 2)))
    attn = torch.from_numpy(rng.uniform(0.1, 1.0, (n, lq, m, 2, p)))
    inputs = [t.requires_grad_() for t in (value, locs, attn)]
    assert torch.autograd.gradcheck(
        lambda v, lc, at: ms_deform_attn_reference(v, shapes, lc, at), inputs)


@pytest.mark.parametrize("levels", sorted(LEVEL_SETS))
def test_separable_matches_jax_separable(levels):
    shapes = LEVEL_SETS[levels]
    value, locs, attn = _inputs(shapes, seed=21)
    want = np.asarray(ms_deform_attn_separable(jnp.asarray(value), shapes,
                                               jnp.asarray(locs), jnp.asarray(attn)))
    v, lc, at = _t(value, locs, attn)
    got = port_msda.ms_deform_attn_separable(v, shapes, lc, at).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_separable_gradients_match_jax_separable():
    """The bench's --bwd sep times autograd through the plain separable
    version; its gradients are jax.grad's of the JAX one."""
    shapes = LEVEL_SETS["two_levels"]
    value, locs, attn = _inputs(shapes, seed=22)
    g = _cotangent(value, locs, seed=23)

    def loss(v, lc, at):
        return (ms_deform_attn_separable(v, shapes, lc, at) * g).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (value, locs, attn)))
    inputs = [t.requires_grad_() for t in _t(value, locs, attn)]
    out = port_msda.ms_deform_attn_separable(inputs[0], shapes, *inputs[1:])
    got = torch.autograd.grad(out, inputs, torch.from_numpy(g))
    for name, a, b in zip(("d_value", "d_locs", "d_attn"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_layout_conversions_round_trip_exactly():
    rng = np.random.default_rng(24)
    x, y, aw = (rng.random((2, 4, 3, 2, 5)).astype(np.float32) for _ in range(3))
    want_locs, want_attn = jax_cm_to_standard(*map(jnp.asarray, (x, y, aw)))
    locs, attn = _cm_to_standard(*_t(x, y, aw))
    assert locs.is_contiguous() and attn.is_contiguous()
    np.testing.assert_array_equal(locs.numpy(), np.asarray(want_locs))
    np.testing.assert_array_equal(attn.numpy(), np.asarray(want_attn))
    for a, b in zip(_standard_to_cm(locs, attn), (x, y, aw)):
        assert a.is_contiguous()
        np.testing.assert_array_equal(a.numpy(), b)


def test_dispatcher_takes_the_plain_version_for_cpu_tensors():
    shapes = LEVEL_SETS["two_levels"]
    value, locs, attn = _t(*_inputs(shapes, seed=25))
    port_msda.std_launches = port_msda.std_bwd_launches = 0
    args = [t.requires_grad_() for t in (value, locs, attn)]
    out = ms_deform_attn_fast(args[0], shapes, *args[1:])
    assert torch.equal(out, ms_deform_attn_reference(value, shapes, locs, attn))
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(26))
    got = torch.autograd.grad(out, args, g)
    want = ms_deform_attn_backward(value.detach(), shapes, locs.detach(), attn.detach(), g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert port_msda.std_launches == 0 and port_msda.std_bwd_launches == 0
    # bf16 value: float32 sampling, output in the value's dtype
    out16 = ms_deform_attn_fast(value.detach().bfloat16(), shapes, locs.detach(),
                                attn.detach())
    assert out16.dtype == torch.bfloat16


def test_dispatcher_raises_instead_of_falling_back():
    shapes = LEVEL_SETS["two_levels"]
    value, locs, attn = _t(*_inputs(shapes, seed=27))
    with pytest.raises(ValueError, match="no path for device meta"):
        ms_deform_attn_fast(value.to("meta"), shapes, locs.to("meta"), attn.to("meta"))
    g = torch.zeros(value.shape[0], locs.shape[1], value.shape[2] * value.shape[3])
    with pytest.raises(ValueError, match="no path for device meta"):
        ms_deform_attn_backward(value.to("meta"), shapes, locs.to("meta"), attn.to("meta"),
                                g.to("meta"))
    with pytest.raises(ValueError, match="S="):
        ms_deform_attn_fast(value, ((6, 4), (3, 3)), locs, attn)
    with pytest.raises(ValueError, match="attn"):
        ms_deform_attn_fast(value, shapes, locs, attn[..., :-1])
    with pytest.raises(ValueError, match="locs must be"):
        ms_deform_attn_fast(value, shapes, locs[..., 0], attn)
    with pytest.raises(ValueError, match="levels"):
        ms_deform_attn_fast(value, (), locs, attn)
