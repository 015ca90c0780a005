"""The PyTorch port's eval forward and inference engine against the JAX model.

Weights go JAX init -> seeded noise -> numpy -> ``load_jax_params``; inputs
come from a numpy seed and go through both packages on the CPU, the JAX
side in float32 with the XLA gather MSDA, the port's through the plain MSDA
version.  The bounds are those of tests/test_golden_parity.py: logits,
boxes and reference points at 2e-3, masks at 5e-3 after scaling by the
largest |mask| (the two frameworks order float32 sums differently through
a ResNet-50, a transformer and FFTs).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import torch

from ocpg_tpu.config import OCPGConfig as JaxConfig
from ocpg_tpu.engine.infer import ClipInferenceEngine as JaxEngine
from ocpg_tpu.engine.infer import InferRequest as JaxRequest
from ocpg_tpu.models import build_model as jax_build_model

from ocpg_tpu_torch.config import OCPGConfig
from ocpg_tpu_torch.engine.infer import ClipInferenceEngine, InferRequest
from ocpg_tpu_torch.models.build import build_model
from ocpg_tpu_torch.utils.weights import load_jax_params

from tests.torch_threads import one_torch_thread  # noqa: F401

B, T, H, W, LT = 1, 2, 192, 256, 8
LOGIT_ATOL = 2e-3
MASK_ATOL = 5e-3


def _jax_cfg(dataset_file):
    return JaxConfig(backbone="resnet50", enc_layers=1, dec_layers=2,
                     dim_feedforward=64, num_queries=5, num_frames=T,
                     compute_dtype="float32", dataset_file=dataset_file,
                     text_layers=2, text_hidden=128, text_heads=4,
                     text_ffn=256, text_vocab=1000, text_max_pos=40,
                     msda_impl="xla")


def port_config(jcfg) -> OCPGConfig:
    names = {f.name for f in dataclasses.fields(OCPGConfig)}
    return OCPGConfig(**{k: getattr(jcfg, k) for k in names})


def random_variables(jmodel, seed):
    """The JAX model's variables tree as numpy arrays of seeded noise
    (running variances kept positive); only the shapes come from init."""
    h = w = 64
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, T, h, w, 3)), jnp.zeros((1, T, h, w), bool),
        jnp.zeros((1, LT), jnp.int32), jnp.ones((1, LT), jnp.int32),
        jnp.asarray([[h, w]], jnp.int32), train=False))
    rng = np.random.default_rng(seed)

    def fill(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "running_var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (rng.standard_normal(x.shape) * 0.05).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def weights():
    model, *_ = jax_build_model(_jax_cfg("davis"))
    return random_variables(model, seed=2)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    samples = rng.standard_normal((B, T, H, W, 3)).astype(np.float32)
    smask = np.zeros((B, T, H, W), bool)
    smask[..., -32:] = True          # right padding
    smask[..., -16:, :] = True       # bottom padding
    ids = rng.integers(4, 999, (B, LT)).astype(np.int32)
    mask = np.ones((B, LT), np.int32)
    ids[:, -2:] = 1
    mask[:, -2:] = 0
    sizes = np.asarray([[H - 16, W - 32]], np.int32)
    return samples, smask, ids, mask, sizes


def _port_model(jcfg, weights):
    model = build_model(port_config(jcfg), device="cpu")
    load_jax_params(model, weights)
    return model


def _assert_masks(got, want):
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-3)
    np.testing.assert_allclose(got / scale, want / scale, atol=MASK_ATOL)


@pytest.mark.parametrize("branch", ["davis", "a2d"])
def test_eval_forward_matches_jax(weights, inputs, branch):
    jcfg = _jax_cfg(branch)
    jmodel, *_ = jax_build_model(jcfg)
    vidx = np.asarray([1], np.int32) if branch == "a2d" else None
    j_out = jax.jit(lambda v, a, vi: jmodel.apply(v, *a, valid_indices=vi, train=False))(
        weights, tuple(map(jnp.asarray, inputs)), None if vidx is None else jnp.asarray(vidx))

    model = _port_model(jcfg, weights)
    t_out = model(*(torch.from_numpy(a) for a in inputs),
                  valid_indices=None if vidx is None else torch.from_numpy(vidx))

    keys = ["pred_logits", "pred_boxes"]
    if branch == "davis":
        keys += ["reference_points", "query_scores"]
    for k in keys:
        np.testing.assert_allclose(t_out[k].numpy(), np.asarray(j_out[k]),
                                   atol=LOGIT_ATOL, err_msg=k)
    q = 1 if branch == "davis" else 5
    t = T if branch == "davis" else 1
    assert t_out["pred_masks"].shape == (B, t, q, H, W)
    _assert_masks(t_out["pred_masks"].numpy(), np.asarray(j_out["pred_masks"]))


def test_engine_matches_jax_engine(weights):
    jcfg = _jax_cfg("davis")
    jmodel, *_ = jax_build_model(jcfg)
    mesh = Mesh(np.asarray(jax.devices("cpu")[:1]), ("data",))
    buckets = ((64, 64), (64, 128))
    jeng = JaxEngine(jmodel, weights, mesh=mesh, clip_len=2, buckets=buckets,
                     want_query_scores=True, want_ref_points=True)
    peng = ClipInferenceEngine(_port_model(jcfg, weights), clip_len=2, buckets=buckets,
                               want_query_scores=True, want_ref_points=True,
                               device="cpu")
    rng = np.random.default_rng(5)
    shapes = [(1, 60, 64, -1), (2, 64, 100, 2), (2, 48, 56, -1)]
    reqs = []
    for i, (t, h, w, qov) in enumerate(shapes):
        frames = rng.integers(0, 256, (t, h, w, 3)).astype(np.uint8)
        ids = np.asarray([0] + [5 + i] * 4 + [2, 1, 1], np.int32)
        tmask = np.asarray([1] * 6 + [0, 0], np.int32)
        reqs.append((frames, ids, tmask, qov))
    j_res = jeng.run([JaxRequest(*r) for r in reqs])
    p_res = peng.run([InferRequest(*r) for r in reqs])
    assert peng.n_batches == jeng.n_batches == 3
    assert peng.canvas_count == jeng.compile_count == 2
    for i, (t, h, w, _) in enumerate(shapes):
        assert p_res[i].shape == j_res[i].shape == (t, h, w)
        _assert_masks(p_res[i], j_res[i])
        np.testing.assert_allclose(peng.last_query_scores[i], jeng.last_query_scores[i],
                                   atol=LOGIT_ATOL)
        np.testing.assert_allclose(peng.last_ref_points[i], jeng.last_ref_points[i],
                                   atol=LOGIT_ATOL)


def test_load_jax_params_is_strict(weights):
    model = build_model(port_config(_jax_cfg("davis")), device="cpu")
    missing = jax.tree_util.tree_map(lambda x: x, weights)
    del missing["params"]["query_embed"]
    with pytest.raises(KeyError, match="query_embed"):
        load_jax_params(model, missing)
    extra = jax.tree_util.tree_map(lambda x: x, weights)
    extra["params"]["stray"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="stray.weight"):
        load_jax_params(model, extra)
    bad = jax.tree_util.tree_map(lambda x: x, weights)
    bad["params"]["query_embed"] = np.zeros((4, 256), np.float32)
    with pytest.raises(ValueError, match="query_embed"):
        load_jax_params(model, bad)


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu():
    cfg = port_config(_jax_cfg("davis"))
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU refusal cannot be shown here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClipInferenceEngine(model)
