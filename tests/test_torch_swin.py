"""The port's Swin backbones and the Swin OCPG model against the JAX package,
on the CPU, in float32.

Weights: the shapes of a JAX init filled with seeded noise, carried into the
port by ``load_jax_params``.  The JAX side runs window attention through
``window_attention_xla``, the port's through its plain version.  Bounds:
the blocks and backbones at 1e-4 (float32 sums in another order through
LayerNorms and a few blocks; measured 7e-7 for a block, up to 2.3e-5 at
the backbone's last level), the OCPG eval forward and the
engine at the golden bounds of tests/test_torch_model.py (logits, boxes and
reference points 2e-3; masks 5e-3 of the largest |mask|).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import torch

from ocpg_tpu.engine.infer import ClipInferenceEngine as JaxEngine
from ocpg_tpu.engine.infer import InferRequest as JaxRequest
from ocpg_tpu.models import backbone_swin2d as jax_swin2d
from ocpg_tpu.models import backbone_video_swin as jax_swin
from ocpg_tpu.models import build_model as jax_build_model

from ocpg_tpu_torch.engine.infer import ClipInferenceEngine, InferRequest
from ocpg_tpu_torch.models import backbone_swin2d, backbone_video_swin
from ocpg_tpu_torch.models.build import build_model
from ocpg_tpu_torch.utils.weights import load_jax_params

from tests.test_torch_model import LOGIT_ATOL, MASK_ATOL, _jax_cfg, port_config, \
    random_variables
from tests.torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-4
B, T, H, W, LT = 1, 3, 128, 192, 8
SMALL = dict(embed_dim=32, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8))


def _noise(params, seed):
    """Seeded noise in every leaf: LayerNorm scales about 1, the rest 0.1 x N(0, 1)."""
    rng = np.random.default_rng(seed)

    def fill(path, x):
        z = rng.standard_normal(x.shape).astype(np.float32)
        return 1.0 + 0.1 * z if str(getattr(path[-1], "key", "")) == "scale" else 0.1 * z

    return jax.tree_util.tree_map_with_path(fill, params)


def _carry(jmodule, port, x, seed, **kw):
    """JAX init shapes -> noise -> the port; returns the JAX module's output."""
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0), x, **kw))
    variables = {"params": _noise(shapes["params"], seed)}
    assert load_jax_params(port, variables) == []
    return jax.jit(lambda v, a: jmodule.apply(v, a, **kw))(variables, x)


@pytest.mark.parametrize("shift", [False, True])
def test_swin_block_matches_jax(shift):
    """T = 3 < 8 (temporal window clamped, no temporal shift), H and W not
    multiples of 7 (padded after norm1): the bias index is the full (8, 7, 7)
    window's cut to 147 x 147, and the SW-MSA mask is built on the padded dims."""
    x = np.random.default_rng(0).standard_normal((2, 3, 10, 12, 32)).astype(np.float32)
    port = backbone_video_swin.SwinBlock3D(32, 2, (8, 7, 7), shift=shift).eval()
    want = _carry(jax_swin.SwinBlock3D(32, 2, (8, 7, 7), shift=shift), port,
                  jnp.asarray(x), seed=1)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_patch_merging_at_odd_sizes_matches_jax():
    x = np.random.default_rng(2).standard_normal((1, 2, 5, 7, 16)).astype(np.float32)
    port = backbone_video_swin.PatchMerging(16)
    want = _carry(jax_swin.PatchMerging(16), port, jnp.asarray(x), seed=3)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (1, 2, 3, 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("variant", ["video_swin_test", "swin2d_small"])
def test_backbone_matches_jax(variant):
    """The whole backbone, four levels: the video variant over a 3-frame clip
    at 61 x 90 (flax 'SAME' padding of the patch conv: 1 + 2 rows, 1 + 1
    columns; odd widths at PatchMerging), the 2D variant (window (1, 7, 7),
    each frame alone) at the same size."""
    if variant == "video_swin_test":
        jmod = jax_swin.build_video_swin(variant, num_frames=T)
        port, kw = backbone_video_swin.build_video_swin(variant), {"num_frames": T}
    else:
        jmod = jax_swin.VideoSwin(window_size=(1, 7, 7), num_frames=1, **SMALL)
        port, kw = backbone_video_swin.VideoSwin(window_size=(1, 7, 7), num_frames=1,
                                                 **SMALL), {}
    frames = np.random.default_rng(4).standard_normal((T, 61, 90, 3)).astype(np.float32)
    want = _carry(jmod, port.eval(), jnp.asarray(frames), seed=5)
    with torch.no_grad():
        got = port(torch.from_numpy(frames).permute(0, 3, 1, 2), **kw)
    assert [tuple(g.shape) for g in got] == [(T, 32, 16, 23), (T, 64, 8, 12),
                                             (T, 128, 4, 6), (T, 256, 2, 3)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), atol=ATOL)


def test_swin_configs_match_jax():
    assert backbone_video_swin._CONFIGS == jax_swin._CONFIGS
    assert backbone_swin2d._CONFIGS == jax_swin2d._CONFIGS
    port = backbone_swin2d.build_swin_2d("swin_t_p4w7")
    assert port.num_frames == 1 and port.stage0_block0.window_size == (1, 7, 7)
    assert port.num_channels == (96, 192, 384, 768)


def _swin_cfg(branch):
    return _jax_cfg(branch).replace(backbone="video_swin_test", num_frames=T)


@pytest.fixture(scope="module")
def weights():
    model, *_ = jax_build_model(_swin_cfg("davis"))
    return random_variables(model, seed=6)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    samples = rng.standard_normal((B, T, H, W, 3)).astype(np.float32)
    smask = np.zeros((B, T, H, W), bool)
    smask[..., -32:] = True
    smask[..., -16:, :] = True
    ids = rng.integers(4, 999, (B, LT)).astype(np.int32)
    mask = np.ones((B, LT), np.int32)
    ids[:, -2:] = 1
    mask[:, -2:] = 0
    sizes = np.asarray([[H - 16, W - 32]], np.int32)
    return samples, smask, ids, mask, sizes


def _port_model(branch, weights):
    model = build_model(port_config(_swin_cfg(branch)), device="cpu")
    load_jax_params(model, weights)
    return model


def _assert_masks(got, want):
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-3)
    np.testing.assert_allclose(got / scale, want / scale, atol=MASK_ATOL)


@pytest.mark.parametrize("branch", ["davis", "a2d"])
def test_swin_eval_forward_matches_jax(weights, inputs, branch):
    jmodel, *_ = jax_build_model(_swin_cfg(branch))
    vidx = np.asarray([1], np.int32) if branch == "a2d" else None
    j_out = jax.jit(lambda v, a, vi: jmodel.apply(v, *a, valid_indices=vi, train=False))(
        weights, tuple(map(jnp.asarray, inputs)), None if vidx is None else jnp.asarray(vidx))
    t_out = _port_model(branch, weights)(
        *(torch.from_numpy(a) for a in inputs),
        valid_indices=None if vidx is None else torch.from_numpy(vidx))
    keys = ["pred_logits", "pred_boxes"]
    if branch == "davis":
        keys += ["reference_points", "query_scores"]
    for k in keys:
        np.testing.assert_allclose(t_out[k].numpy(), np.asarray(j_out[k]),
                                   atol=LOGIT_ATOL, err_msg=k)
    _assert_masks(t_out["pred_masks"].numpy(), np.asarray(j_out["pred_masks"]))


def test_swin_engine_matches_jax_engine(weights):
    """Short clips are zero-padded to clip_len, and the video Swin attends
    across the padded frames in both packages."""
    jmodel, *_ = jax_build_model(_swin_cfg("davis"))
    mesh = Mesh(np.asarray(jax.devices("cpu")[:1]), ("data",))
    buckets = ((64, 128),)
    jeng = JaxEngine(jmodel, weights, mesh=mesh, clip_len=T, buckets=buckets,
                     want_query_scores=True)
    peng = ClipInferenceEngine(_port_model("davis", weights), clip_len=T, buckets=buckets,
                               want_query_scores=True, device="cpu")
    rng = np.random.default_rng(8)
    shapes = [(1, 60, 128), (3, 64, 100), (2, 48, 56)]
    reqs = []
    for i, (t, h, w) in enumerate(shapes):
        frames = rng.integers(0, 256, (t, h, w, 3)).astype(np.uint8)
        ids = np.asarray([0] + [5 + i] * 4 + [2, 1, 1], np.int32)
        tmask = np.asarray([1] * 6 + [0, 0], np.int32)
        reqs.append((frames, ids, tmask))
    j_res = jeng.run([JaxRequest(*r) for r in reqs])
    p_res = peng.run([InferRequest(*r) for r in reqs])
    assert peng.n_batches == jeng.n_batches == 3
    for i, (t, h, w) in enumerate(shapes):
        assert p_res[i].shape == j_res[i].shape == (t, h, w)
        _assert_masks(p_res[i], j_res[i])
        np.testing.assert_allclose(peng.last_query_scores[i], jeng.last_query_scores[i],
                                   atol=LOGIT_ATOL)
