"""The port's MSDA forward and backward (``ocpg_tpu_torch/ops/ms_deform_attn.py``)
against the JAX package's, on the CPU.

* The plain version against the JAX float32 gather path ``ms_deform_attn``
  at rtol/atol 1e-5 (the bound of tests/test_ms_deform_attn_pallas.py for
  two float32 formulations of one function), over several level sets, with
  samples outside the map and samples on exactly-integer pixel coordinates.
* The plain version against the interpreted Pallas kernel
  ``ms_deform_attn_pallas_cm`` at 2e-2: the TPU kernel rounds the value and
  its hat rows to bfloat16.
* The dispatcher: a CPU tensor takes the plain version and launches nothing;
  a device with no path and malformed inputs raise.
* The plain backward (autograd through the plain version) against
  ``jax.grad`` of the JAX gather path at 1e-4 (the bound of
  tests/test_ms_deform_attn_pallas.py for those gradients), including
  samples exactly on integer pixels and at xp = -1, where the derivative is
  the right-sided one; against the interpreted Pallas backward
  ``ms_deform_attn_pallas_bwd_cm`` at 2e-2 of each gradient's max (it rounds
  its operands to bfloat16); zero coordinate and weight gradients at
  non-finite coordinates; and ``torch.autograd.gradcheck`` in float64.

The CUDA kernels themselves are held against the plain versions on the
card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ocpg_tpu.ops.ms_deform_attn import _cm_to_standard, ms_deform_attn
from ocpg_tpu.ops.ms_deform_attn_pallas import (ms_deform_attn_pallas_bwd_cm,
                                                 ms_deform_attn_pallas_cm)

from ocpg_tpu_torch.ops import ms_deform_attn as port_msda
from ocpg_tpu_torch.ops.ms_deform_attn import (ms_deform_attn_cm,
                                                ms_deform_attn_cm_backward,
                                                ms_deform_attn_cm_reference)

LEVEL_SETS = {
    "two_levels": ((6, 4), (3, 2)),
    "four_levels_to_1x1": ((8, 10), (4, 5), (2, 3), (1, 1)),
    "one_level": ((5, 7),),
}
# power-of-two sizes: x * W is exact in float32 whatever the multiply-add
# contraction, so both packages see the same exactly-integer coordinates
POW2_LEVELS = ((8, 4), (4, 2), (2, 1))


def _inputs(shapes, seed, n=2, m=4, d=8, lq=6, p=3, integer_coords=False):
    """value (N, S, M, D); x, y, aw (N, M, L, P, Lq); locations in
    [-0.1, 1.1] so some samples fall outside the map."""
    rng = np.random.default_rng(seed)
    l = len(shapes)
    s = sum(h * w for h, w in shapes)
    value = rng.standard_normal((n, s, m, d)).astype(np.float32)
    x = (rng.random((n, m, l, p, lq)) * 1.2 - 0.1).astype(np.float32)
    y = (rng.random((n, m, l, p, lq)) * 1.2 - 0.1).astype(np.float32)
    aw = rng.random((n, m, l, p, lq)).astype(np.float32)
    aw /= aw.sum(axis=(2, 3), keepdims=True)
    if integer_coords:
        # (k + 0.5) / W lands exactly on pixel k in float32 (and k = -1, W
        # on the first corner outside the map)
        for lid, (h, w) in enumerate(shapes):
            kx = rng.integers(-1, w + 1, (n, m, p, lq))
            ky = rng.integers(-1, h + 1, (n, m, p, lq))
            x[:, :, lid] = ((kx + 0.5) / w).astype(np.float32)
            y[:, :, lid, : p // 2 + 1] = ((ky + 0.5) / h).astype(np.float32)[:, :, : p // 2 + 1]
    return value, x, y, aw


def _port(value, shapes, x, y, aw):
    return ms_deform_attn_cm_reference(torch.from_numpy(value), shapes,
                                       *map(torch.from_numpy, (x, y, aw))).numpy()


@pytest.mark.parametrize("integer_coords", [False, True])
@pytest.mark.parametrize("levels", sorted(LEVEL_SETS))
def test_plain_matches_jax_gather(levels, integer_coords):
    shapes = LEVEL_SETS[levels]
    value, x, y, aw = _inputs(shapes, seed=1, integer_coords=integer_coords)
    locs, attn = _cm_to_standard(jnp.asarray(x), jnp.asarray(y), jnp.asarray(aw))
    want = np.asarray(ms_deform_attn(jnp.asarray(value), shapes, locs, attn))
    got = _port(value, shapes, x, y, aw)
    assert got.shape == (value.shape[0], x.shape[-1], value.shape[2] * value.shape[3])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_plain_matches_jax_at_transformer_width():
    """D = 32 channels per head and P = 4 points, as the model runs it."""
    shapes = LEVEL_SETS["four_levels_to_1x1"]
    value, x, y, aw = _inputs(shapes, seed=4, n=1, m=8, d=32, lq=9, p=4)
    locs, attn = _cm_to_standard(jnp.asarray(x), jnp.asarray(y), jnp.asarray(aw))
    want = np.asarray(ms_deform_attn(jnp.asarray(value), shapes, locs, attn))
    np.testing.assert_allclose(_port(value, shapes, x, y, aw), want, rtol=1e-5, atol=1e-5)


def test_plain_matches_interpreted_pallas_kernel():
    shapes = LEVEL_SETS["two_levels"]
    value, x, y, aw = _inputs(shapes, seed=2)
    want = np.asarray(ms_deform_attn_pallas_cm(
        jnp.asarray(value), shapes, jnp.asarray(x), jnp.asarray(y), jnp.asarray(aw),
        128, True))
    np.testing.assert_allclose(_port(value, shapes, x, y, aw), want, rtol=2e-2, atol=2e-2)


def test_non_finite_coordinates_sample_nothing():
    """A wholly padded frame has valid ratio 0 and NaN reference points; the
    JAX gather path and the kernel give 0 for such samples."""
    shapes = LEVEL_SETS["two_levels"]
    value, x, y, aw = _inputs(shapes, seed=3)
    x[0, :, :, :, 0] = np.nan
    y[1, :, 1, :, 2] = np.inf
    locs, attn = _cm_to_standard(jnp.asarray(x), jnp.asarray(y), jnp.asarray(aw))
    want = np.asarray(ms_deform_attn(jnp.asarray(value), shapes, locs, attn))
    got = _port(value, shapes, x, y, aw)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_dispatcher_takes_the_plain_version_for_cpu_tensors():
    shapes = LEVEL_SETS["two_levels"]
    arrays = [torch.from_numpy(a) for a in _inputs(shapes, seed=5)]
    port_msda.launches = 0
    got = ms_deform_attn_cm(arrays[0], shapes, *arrays[1:])
    assert port_msda.launches == 0
    want = ms_deform_attn_cm_reference(arrays[0], shapes, *arrays[1:])
    assert torch.equal(got, want)
    # bf16 value: float32 sampling, output in the value's dtype
    got16 = ms_deform_attn_cm(arrays[0].bfloat16(), shapes, *arrays[1:])
    assert got16.dtype == torch.bfloat16
    want16 = ms_deform_attn_cm_reference(arrays[0].bfloat16().float(), shapes, *arrays[1:])
    np.testing.assert_allclose(got16.float().numpy(), want16.numpy(), rtol=1e-2, atol=1e-2)


def test_dispatcher_raises_instead_of_falling_back():
    shapes = LEVEL_SETS["two_levels"]
    value, x, y, aw = (torch.from_numpy(a) for a in _inputs(shapes, seed=6))
    with pytest.raises(ValueError, match="no path for device meta"):
        ms_deform_attn_cm(value.to("meta"), shapes, x.to("meta"), y.to("meta"),
                          aw.to("meta"))
    with pytest.raises(ValueError, match="S="):
        ms_deform_attn_cm(value, ((6, 4), (3, 3)), x, y, aw)
    with pytest.raises(ValueError, match="aw_cm"):
        ms_deform_attn_cm(value, shapes, x, y, aw[..., :-1])
    with pytest.raises(ValueError, match="levels"):
        ms_deform_attn_cm(value, (), x, y, aw)


@pytest.mark.parametrize("entry,dtype,d,offset,match", [
    ("cm", torch.bfloat16, 12, 0, "multiple of 8"),
    ("cm", torch.float32, 6, 0, "multiple of 4"),
    ("cm", torch.bfloat16, 16, 1, "16-byte aligned"),
    ("cm", torch.float32, 8, 0, "is on cpu"),
    ("std", torch.bfloat16, 12, 0, "multiple of 8"),
    ("std", torch.float32, 8, 1, "16-byte aligned"),
])
def test_forward_kernel_rules_are_checked_before_launch(entry, dtype, d, offset, match):
    """The forward kernel (K1 and its standard-layout entry K3) gathers 16
    bytes of channels a thread: D a multiple of 8 (bf16) or 4 (float32),
    and a 16-byte aligned value; a value that keeps both rules reaches the
    device checks."""
    shapes = LEVEL_SETS["two_levels"]
    value, x, y, aw = (torch.from_numpy(a) for a in _inputs(shapes, seed=8, d=d))
    flat = torch.zeros(value.numel() + offset, dtype=dtype)
    value = flat[offset:].view(value.shape)
    with pytest.raises(ValueError, match=match):
        if entry == "cm":
            port_msda._launch(value, shapes, x, y, aw)
        else:
            port_msda._launch_std(value, shapes, *port_msda._cm_to_standard(x, y, aw))


# ------------------------------------------------------------- backward --
def _jax_grads(value, shapes, x, y, aw, g):
    """jax.grad of <ms_deform_attn(value, ...), g> through the gather path,
    in CM layout."""
    def loss(v, xc, yc, a):
        locs, attn = _cm_to_standard(xc, yc, a)
        return (ms_deform_attn(v, shapes, locs, attn) * g).sum()

    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (value, x, y, aw)))
    return [np.asarray(a) for a in grads]


def _port_grads(value, shapes, x, y, aw, g):
    return [t.numpy() for t in ms_deform_attn_cm_backward(
        *_torch(value, shapes, x, y, aw), torch.from_numpy(g))]


def _torch(value, shapes, x, y, aw):
    return (torch.from_numpy(value), shapes, *map(torch.from_numpy, (x, y, aw)))


def _cotangent(value, x, seed):
    n, _, m, d = value.shape
    return np.random.default_rng(seed).standard_normal((n, x.shape[-1], m * d)).astype(
        np.float32)


@pytest.mark.parametrize("levels,integer_coords", [
    ("two_levels", False), ("four_levels_to_1x1", False), ("pow2", False), ("pow2", True)])
def test_plain_backward_matches_jax_gather_grad(levels, integer_coords):
    """Exact pixel coordinates only on power-of-two level sizes (POW2_LEVELS)."""
    shapes = POW2_LEVELS if levels == "pow2" else LEVEL_SETS[levels]
    value, x, y, aw = _inputs(shapes, seed=11, integer_coords=integer_coords)
    g = _cotangent(value, x, seed=12)
    for name, got, want in zip(("d_value", "d_x", "d_y", "d_aw"),
                               _port_grads(value, shapes, x, y, aw, g),
                               _jax_grads(value, shapes, x, y, aw, g)):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=name)


def test_plain_backward_is_right_sided_at_xp_minus_one():
    """x = -0.5 / W puts xp at exactly -1: the forward is 0 there, the
    right-sided derivative is aw * v[., 0] * W, as the JAX gather autodiff."""
    shapes = POW2_LEVELS
    value, x, y, aw = _inputs(shapes, seed=13)
    for lid, (h, w) in enumerate(shapes):
        x[:, :, lid, 0] = -0.5 / w
    g = _cotangent(value, x, seed=14)
    got = _port_grads(value, shapes, x, y, aw, g)
    want = _jax_grads(value, shapes, x, y, aw, g)
    assert np.abs(want[1][:, :, :, 0]).max() > 0.1      # the derivative is not 0
    for name, a, b in zip(("d_value", "d_x", "d_y", "d_aw"), got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=name)


def test_plain_backward_matches_interpreted_pallas_kernel():
    shapes = LEVEL_SETS["two_levels"]
    value, x, y, aw = _inputs(shapes, seed=15)
    g = _cotangent(value, x, seed=16)
    want = ms_deform_attn_pallas_bwd_cm(*map(jnp.asarray, (value,)), shapes,
                                        *map(jnp.asarray, (x, y, aw, g)), 128, True)
    for name, got, ref in zip(("d_value", "d_x", "d_y", "d_aw"),
                              _port_grads(value, shapes, x, y, aw, g), want):
        ref = np.asarray(ref, np.float32)
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got / scale, ref / scale, atol=2e-2, err_msg=name)


def test_plain_backward_at_non_finite_coordinates():
    """NaN / inf coordinates (wholly padded frames): zero d_x, d_y and d_aw
    there, and a finite d_value."""
    shapes = LEVEL_SETS["two_levels"]
    value, x, y, aw = _inputs(shapes, seed=17)
    x[0, :, :, :, 0] = np.nan
    y[1, :, 1, :, 2] = np.inf
    g = _cotangent(value, x, seed=18)
    d_value, d_x, d_y, d_aw = _port_grads(value, shapes, x, y, aw, g)
    assert np.isfinite(d_value).all()
    for grad in (d_x, d_y, d_aw):
        assert np.isfinite(grad).all()
        assert (grad[0, :, :, :, 0] == 0).all() and (grad[1, :, 1, :, 2] == 0).all()
        assert np.abs(grad).max() > 0


def test_plain_version_gradcheck_float64():
    """Away from the kinks (coordinates off the pixel grid and the borders)."""
    shapes = ((3, 4), (2, 2))
    rng = np.random.default_rng(19)
    n, m, d, p, lq = 1, 2, 3, 2, 3
    value = torch.from_numpy(rng.standard_normal((n, 16, m, d)))
    x = torch.from_numpy(rng.uniform(0.15, 0.85, (n, m, 2, p, lq)))
    y = torch.from_numpy(rng.uniform(0.15, 0.85, (n, m, 2, p, lq)))
    aw = torch.from_numpy(rng.uniform(0.1, 1.0, (n, m, 2, p, lq)))
    inputs = [t.requires_grad_() for t in (value, x, y, aw)]
    assert torch.autograd.gradcheck(
        lambda v, a, b, c: ms_deform_attn_cm_reference(v, shapes, a, b, c), inputs)


def test_cpu_backward_launches_nothing():
    shapes = LEVEL_SETS["two_levels"]
    value, x, y, aw = _inputs(shapes, seed=20)
    g = _cotangent(value, x, seed=21)
    port_msda.bwd_launches = 0
    got = _port_grads(value, shapes, x, y, aw, g)
    assert port_msda.bwd_launches == 0
    # the same as autograd through the dispatcher
    args = [t.requires_grad_() for t in map(torch.from_numpy, (value, x, y, aw))]
    out = ms_deform_attn_cm(args[0], shapes, *args[1:])
    want = torch.autograd.grad(out, args, torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b.numpy())
