"""The port's forward-only MSDA reformulations (``ocpg_tpu_torch/ops/
ms_deform_attn_variants.py``) and its MSDA kernel bench
(``ocpg_tpu_torch/scripts/bench_msda_kernel.py``) against the JAX package,
on the CPU.

* The plain dense-row (r4) and fused-K (fk) versions against the
  interpreted Pallas kernels ``ms_deform_attn_pallas_cm_r4`` (K5) and
  ``ms_deform_attn_pallas_cm_fk`` (K6) at 2e-2 (the TPU kernels round their
  matmul operands to bfloat16; finite inputs, since the interpreted kernels
  return NaN at a non-finite coordinate), and against the JAX float32
  gather path at rtol/atol 1e-5, with samples outside the map and on
  exactly-integer pixel coordinates.
* At non-finite coordinates both sample nothing, as the plain gather
  version does.
* The dispatchers: CPU tensors take the plain versions and launch nothing; a
  device with no path and malformed inputs raise.
* The bench entry runs cm r4 fk sep with --bwd on the CPU at a small level
  set, and refuses the TPU-only variants and --tile.

The CUDA kernels themselves are held against the plain versions on the
card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ocpg_tpu.ops.ms_deform_attn import _cm_to_standard, ms_deform_attn
from ocpg_tpu.ops.ms_deform_attn_pallas import (ms_deform_attn_pallas_cm_fk,
                                                 ms_deform_attn_pallas_cm_r4)

from ocpg_tpu_torch.ops import ms_deform_attn_variants as variants
from ocpg_tpu_torch.ops.ms_deform_attn import ms_deform_attn_cm_reference
from ocpg_tpu_torch.scripts import bench_msda_kernel

from tests.torch_threads import one_torch_thread  # noqa: F401

LEVEL_SETS = {
    "two_levels": ((6, 4), (3, 2)),
    "four_levels_to_1x1": ((8, 10), (4, 5), (2, 3), (1, 1)),
    "pow2": ((8, 4), (4, 2), (2, 1)),
}
PLAIN = {"r4": variants.ms_deform_attn_cm_r4_reference,
         "fk": variants.ms_deform_attn_cm_fk_reference}
DISPATCH = {"r4": variants.ms_deform_attn_cm_r4, "fk": variants.ms_deform_attn_cm_fk}
INTERPRETED = {"r4": ms_deform_attn_pallas_cm_r4, "fk": ms_deform_attn_pallas_cm_fk}


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
        for lid, (h, w) in enumerate(shapes):
            x[:, :, lid] = ((rng.integers(-1, w + 1, (n, m, p, lq)) + 0.5) / w).astype(
                np.float32)
            y[:, :, lid, :1] = ((rng.integers(-1, h + 1, (n, m, 1, lq)) + 0.5) / h).astype(
                np.float32)
    return value, x, y, aw


def _port(name, value, shapes, x, y, aw):
    return PLAIN[name](torch.from_numpy(value), shapes,
                       *map(torch.from_numpy, (x, y, aw))).numpy()


@pytest.mark.parametrize("name", sorted(PLAIN))
def test_plain_matches_interpreted_pallas_kernel(name):
    shapes = LEVEL_SETS["two_levels"]
    value, x, y, aw = _inputs(shapes, seed=1)
    want = np.asarray(INTERPRETED[name](jnp.asarray(value), shapes, jnp.asarray(x),
                                        jnp.asarray(y), jnp.asarray(aw), 128, True))
    np.testing.assert_allclose(_port(name, value, shapes, x, y, aw), want,
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("integer_coords", [False, True])
@pytest.mark.parametrize("levels", sorted(LEVEL_SETS))
@pytest.mark.parametrize("name", sorted(PLAIN))
def test_plain_matches_jax_gather(name, levels, integer_coords):
    shapes = LEVEL_SETS[levels]
    value, x, y, aw = _inputs(shapes, seed=2, integer_coords=integer_coords)
    locs, attn = _cm_to_standard(*map(jnp.asarray, (x, y, aw)))
    want = np.asarray(ms_deform_attn(jnp.asarray(value), shapes, locs, attn))
    got = _port(name, value, shapes, x, y, aw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(PLAIN))
def test_non_finite_coordinates_sample_nothing(name):
    shapes = LEVEL_SETS["two_levels"]
    value, x, y, aw = _inputs(shapes, seed=3)
    x[0, :, :, :, 0] = np.nan
    y[1, :, 1, :, 2] = np.inf
    got = _port(name, value, shapes, x, y, aw)
    want = ms_deform_attn_cm_reference(torch.from_numpy(value), shapes,
                                       *map(torch.from_numpy, (x, y, aw))).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(PLAIN))
def test_dispatcher_takes_the_plain_version_for_cpu_tensors(name):
    shapes = LEVEL_SETS["two_levels"]
    value, x, y, aw = map(torch.from_numpy, _inputs(shapes, seed=4))
    variants.r4_launches = variants.fk_launches = 0
    got = DISPATCH[name](value, shapes, x, y, aw)
    assert torch.equal(got, PLAIN[name](value, shapes, x, y, aw))
    assert variants.r4_launches == 0 and variants.fk_launches == 0
    got16 = DISPATCH[name](value.bfloat16(), shapes, x, y, aw)
    assert got16.dtype == torch.bfloat16


@pytest.mark.parametrize("name", sorted(PLAIN))
def test_dispatcher_raises_instead_of_falling_back(name):
    shapes = LEVEL_SETS["two_levels"]
    value, x, y, aw = map(torch.from_numpy, _inputs(shapes, seed=5))
    fn = DISPATCH[name]
    with pytest.raises(ValueError, match="no path for device meta"):
        fn(value.to("meta"), shapes, x.to("meta"), y.to("meta"), aw.to("meta"))
    with pytest.raises(ValueError, match="S="):
        fn(value, ((6, 4), (3, 3)), x, y, aw)
    with pytest.raises(ValueError, match="aw_cm"):
        fn(value, shapes, x, y, aw[..., :-1])


SMALL_LEVELS = ((6, 4), (3, 2))


def test_bench_runs_every_variant_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setitem(bench_msda_kernel.SHAPE_SETS, "small", SMALL_LEVELS)
    out = bench_msda_kernel.main(["--variants", "cm", "r4", "fk", "sep", "--bwd",
                                  "--shapes", "small", "--n", "1", "--check", "sep"],
                                 device="cpu")
    assert sorted(out["check"]) == ["cm", "fk", "r4", "sep"]
    assert all(e < 2e-2 for e in out["check"].values())
    assert sorted(out["ms"]) == sorted(
        [f"fwd/{v}/small" for v in ("cm", "r4", "fk", "sep")] + ["bwd/cm/small", "bwd/sep/small"])
    assert out["device"] == "cpu" and out["clock"] == "host" and out["nvidia_smi"] is None
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed[-1].startswith('{"bench": "msda_kernel"')


def test_bench_inputs_are_the_jax_benchs():
    """numpy default_rng(0) draws value, x, y, aw and g in the JAX script's
    order; aw sums to 1 over (L, P)."""
    t = bench_msda_kernel.make_inputs(SMALL_LEVELS, 2, "cpu")
    rng = np.random.default_rng(0)
    value = rng.standard_normal((2, 30, 8, 32))
    np.testing.assert_array_equal(t["value"].float().numpy(),
                                  torch.from_numpy(value).bfloat16().float().numpy())
    np.testing.assert_array_equal(t["x"].numpy(), rng.random((2, 8, 2, 4, 30)).astype(
        np.float32))
    np.testing.assert_allclose(t["aw"].sum(dim=(2, 3)).numpy(), 1.0, rtol=1e-6)
    assert t["g"].shape == (2, 30, 256)


@pytest.mark.parametrize("argv", [["--variants", "cm_hc"], ["--variants", "cm", "cm_rep"],
                                  ["--tile", "256"]])
def test_bench_refuses_tpu_only_knobs(argv, capsys):
    with pytest.raises(SystemExit):
        bench_msda_kernel.main(argv, device="cpu")
    assert "Hopper" in capsys.readouterr().err


# --- executed tensor-core FLOPs of the CUDA kernels (r4_mma_flops, fk_mma_flops)

COUNT_LEVELS = ((16, 20), (8, 10), (4, 5))


def _count_inputs(kind, n=2, m=2, p=3, lq=300, seed=11):
    """x, y (N, M, L, P, Lq) float32: uniform over [-0.1, 1.1]; clustered in
    a narrow band (a few chunks and column blocks); or uniform with whole
    samples outside the map and NaN / inf coordinates."""
    rng = np.random.default_rng(seed)
    shape = (n, m, len(COUNT_LEVELS), p, lq)
    if kind == "few_chunks":
        x = rng.uniform(0.3, 0.4, shape)
        y = rng.uniform(0.55, 0.6, shape)
    else:
        x = rng.uniform(-0.1, 1.1, shape)
        y = rng.uniform(-0.1, 1.1, shape)
    if kind == "outside_and_nan":
        x[:, :, :, 0, ::5] = 1.7
        y[:, :, :, 1, ::3] = -0.6
        x[0, :, :, 2, ::7] = np.nan
        y[1, :, 1, :, 2::11] = np.inf
    return x.astype(np.float32), y.astype(np.float32)


def _cells(xn, yn, h, w):
    """The kernels' test of one sample: in-map flag and pixel corner."""
    xp = np.float32(xn) * np.float32(w) - np.float32(0.5)
    yp = np.float32(yn) * np.float32(h) - np.float32(0.5)
    ok = bool(xp > -1 and yp > -1 and xp < w and yp < h)
    return ok, (int(np.floor(xp)) if ok else 0), (int(np.floor(yp)) if ok else 0)


def _r4_brute(x, y, dim):
    """One product per (n, m, 256-query tile, level, 64-key chunk) that an
    in-map corner of the tile lands in, 2 x 256 x 64 x D FLOPs each."""
    n, m, _, p, lq = x.shape
    hit = set()
    for b, mh, lid, pi, q in np.ndindex(n, m, len(COUNT_LEVELS), p, lq):
        h, w = COUNT_LEVELS[lid]
        ok, x0, y0 = _cells(x[b, mh, lid, pi, q], y[b, mh, lid, pi, q], h, w)
        for cx, cy in ((x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1, y0 + 1)):
            if ok and 0 <= cx < w and 0 <= cy < h:
                hit.add((b, mh, q // 256, lid, (cy * w + cx) // 64))
    return len(hit) * 2 * 256 * 64 * dim


def _fk_brute(x, y, dim):
    """Per (n, m, point, 64 query rows, level, block of 64 / D rows h) that
    an in-map y corner row of the rows falls in: the level's 16-deep K steps
    over cx_all, 2 x 64 x 64 x 16 FLOPs each."""
    n, m, _, p, lq = x.shape
    steps, koff = [], 0
    for h, w in COUNT_LEVELS:
        steps.append(-(-(koff + w) // 16) - koff // 16)
        koff += w
    hit = set()
    for b, mh, lid, pi, q in np.ndindex(n, m, len(COUNT_LEVELS), p, lq):
        h, w = COUNT_LEVELS[lid]
        ok, _, y0 = _cells(x[b, mh, lid, pi, q], y[b, mh, lid, pi, q], h, w)
        for cy in (y0, y0 + 1):
            if ok and 0 <= cy < h:
                hit.add((b, mh, pi, q // 64, lid, cy // (64 // dim)))
    return sum(steps[key[4]] for key in hit) * 2 * 64 * 64 * 16


@pytest.mark.parametrize("dim", [32, 8])
@pytest.mark.parametrize("kind", ["uniform", "few_chunks", "outside_and_nan"])
@pytest.mark.parametrize("name", ["r4", "fk"])
def test_mma_flop_count_matches_brute_force(name, kind, dim):
    x, y = _count_inputs(kind)
    count = {"r4": variants.r4_mma_flops, "fk": variants.fk_mma_flops}[name]
    brute = {"r4": _r4_brute, "fk": _fk_brute}[name]
    got = count(COUNT_LEVELS, torch.from_numpy(x), torch.from_numpy(y), dim)
    assert got == brute(x, y, dim)
    assert got > 0


def test_mma_flop_counts_skip_untouched_products():
    """Samples in a narrow band leave most chunks and column blocks out;
    uniform ones touch nearly all of them."""
    for name in ("r4", "fk"):
        count = {"r4": variants.r4_mma_flops, "fk": variants.fk_mma_flops}[name]
        few = count(COUNT_LEVELS, *map(torch.from_numpy, _count_inputs("few_chunks")), 32)
        most = count(COUNT_LEVELS, *map(torch.from_numpy, _count_inputs("uniform")), 32)
        assert 0 < 2 * few <= most
