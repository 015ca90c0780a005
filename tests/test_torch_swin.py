"""The port's Swin backbones and the Swin OCPG model against the JAX package,
on the CPU, in float32.

Weights: the shapes of a JAX init filled with seeded noise, carried into the
port by ``load_jax_params``.  The JAX side runs window attention through
``window_attention_xla``, the port's through its plain version.  Bounds:
the blocks and backbones at 1e-4 (float32 sums in another order through
LayerNorms and a few blocks; measured 7e-7 for a block, up to 2.3e-5 at
the backbone's last level), the OCPG eval forward and the
engine at the golden bounds of tests/test_torch_model.py (logits, boxes and
reference points 2e-3; masks 5e-3 of the largest |mask|).  The 2D Swin-L's
eval forward is also run with the port in bfloat16, which must break one
of those bounds.
"""
import dataclasses

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
# Video Swin-T's widths (video_swin_t_p4w7) with its depths (2, 2, 6, 2) cut
SWIN_T_CUT = dict(embed_dim=96, depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24))
# Swin-L's widths (swin_l_p4w7) with its depths (2, 2, 18, 2) cut
SWIN_L_CUT = dict(embed_dim=192, depths=(2, 2, 2, 2), num_heads=(6, 12, 24, 48))


def _noise(params, seed):
    """Seeded noise in every leaf: LayerNorm scales about 1, the rest 0.1 x N(0, 1)."""
    rng = np.random.default_rng(seed)

    def fill(path, x):
        z = rng.standard_normal(x.shape).astype(np.float32)
        return 1.0 + 0.1 * z if str(getattr(path[-1], "key", "")) == "scale" else 0.1 * z

    return jax.tree_util.tree_map_with_path(fill, params)


def _carry(jmodule, port, x, seed, init=False, **kw):
    """JAX init shapes -> noise (``init``: JAX's own init drawn from ``seed``)
    -> the port; returns the JAX module's output."""
    if init:
        variables = jax.jit(lambda: jmodule.init(jax.random.PRNGKey(seed), x, **kw))()
    else:
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


@pytest.mark.parametrize("variant", ["video_swin_test", "swin2d_small", "video_swin_t_cut",
                                     "swin_l_cut"])
def test_backbone_matches_jax(variant):
    """The whole backbone, four levels: the video variant over a 3-frame clip
    at 61 x 90 (flax 'SAME' padding of the patch conv: 1 + 2 rows, 1 + 1
    columns; odd widths at PatchMerging), the 2D variant (window (1, 7, 7),
    each frame alone) at the same size, and Video Swin-T and the 2D Swin-L
    at their own widths (embed 96, 3/6/12/24 heads; embed 192, 6/12/24/48
    heads; 32 channels a head) with their depths cut to 2 a stage, so that
    every stage has a shifted block."""
    if variant == "video_swin_test":
        jmod = jax_swin.build_video_swin(variant, num_frames=T)
        port, kw = backbone_video_swin.build_video_swin(variant), {"num_frames": T}
    elif variant == "video_swin_t_cut":
        jmod = jax_swin.VideoSwin(num_frames=T, **SWIN_T_CUT)
        port, kw = backbone_video_swin.VideoSwin(**SWIN_T_CUT), {"num_frames": T}
    else:
        widths = SWIN_L_CUT if variant == "swin_l_cut" else SMALL
        jmod = jax_swin.VideoSwin(window_size=(1, 7, 7), num_frames=1, **widths)
        port, kw = backbone_video_swin.VideoSwin(window_size=(1, 7, 7), num_frames=1,
                                                 **widths), {}
    frames = np.random.default_rng(4).standard_normal((T, 61, 90, 3)).astype(np.float32)
    # the cut Swin-T's and Swin-L's weights come from JAX's own initialisers:
    # at their widths 0.1 x N(0, 1) noise grows the last level to |x| ~ 18,
    # where 1e-4 is 5e-6 of it, finer than float32 sums in another order keep
    want = _carry(jmod, port.eval(), jnp.asarray(frames), seed=5,
                  init=variant in ("video_swin_t_cut", "swin_l_cut"))
    with torch.no_grad():
        got = port(torch.from_numpy(frames).permute(0, 3, 1, 2), **kw)
    c = port.embed_dim
    assert [tuple(g.shape) for g in got] == [(T, c, 16, 23), (T, 2 * c, 8, 12),
                                             (T, 4 * c, 4, 6), (T, 8 * c, 2, 3)]
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


def test_swin_t_a2d_eval_forward_matches_jax(inputs, monkeypatch):
    """``a2d_videoswin_tiny`` at its widths (Video Swin-T, the transformer at
    hidden 256 and FFN 2048, RoBERTa-base's 768 x 12 heads), its depths cut
    (Swin 2 a stage, 1 + 2 transformer layers, 2 text layers), in float32:
    the A2D eval forward with valid_indices.  Weights from JAX's own init
    (seeded), as at the backbone's Swin-T case."""
    from ocpg_tpu.config import a2d_videoswin_tiny as jax_a2d_videoswin_tiny

    for configs in (jax_swin._CONFIGS, backbone_video_swin._CONFIGS):
        monkeypatch.setitem(configs, "video_swin_t_p4w7", SWIN_T_CUT)
    jcfg = jax_a2d_videoswin_tiny().replace(
        enc_layers=1, dec_layers=2, text_layers=2, num_frames=T, compute_dtype="float32",
        msda_impl="xla")
    jmodel, *_ = jax_build_model(jcfg)
    samples, smask, ids, mask, sizes = inputs
    ids = ids % jcfg.text_vocab
    args = tuple(map(jnp.asarray, (samples, smask, ids, mask, sizes)))
    vidx = jnp.asarray([1], jnp.int32)
    variables = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(9), *args, valid_indices=vidx,
                                            train=False))()
    j_out = jax.jit(lambda v: jmodel.apply(v, *args, valid_indices=vidx, train=False))(
        variables)
    model = build_model(port_config(jcfg), device="cpu")
    assert model.backbone.embed_dim == 96 and model.backbone.depths == (2, 2, 2, 2)
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, variables))
    t_out = model(*(torch.from_numpy(np.asarray(a)) for a in (samples, smask, ids, mask, sizes)),
                  valid_indices=torch.tensor([1], dtype=torch.int32))
    for k in ("pred_logits", "pred_boxes"):
        np.testing.assert_allclose(t_out[k].detach().numpy(), np.asarray(j_out[k]),
                                   atol=LOGIT_ATOL, err_msg=k)
    _assert_masks(t_out["pred_masks"].detach().numpy(), np.asarray(j_out["pred_masks"]))


def _eval_gaps(t_out, j_out):
    """The worst |gap| of the logits and boxes, and of the masks over the
    largest |mask| (``_assert_masks``'s scale)."""
    logit = max(float(np.abs(t_out[k].detach().float().numpy() - np.asarray(j_out[k])).max())
                for k in ("pred_logits", "pred_boxes"))
    want = np.asarray(j_out["pred_masks"])
    got = t_out["pred_masks"].detach().float().numpy()
    assert got.shape == want.shape
    return logit, float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-3))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_swin_l_eval_forward_matches_jax(inputs, monkeypatch, compute_dtype):
    """The Ref-YTVOS eval forward with the 2D Swin-L of the benchmark's
    ``ocpg_swinl_ytvos`` at its widths, its depths cut to 2 a stage, behind
    the tiny transformer and text encoder; weights from JAX's own init
    (seeded), as at the backbone's cut cases.  In float32 within the golden
    bounds (measured: logits and boxes 4.8e-7, masks 1.1e-6 of the largest);
    with the port computing in bfloat16 (the control) outside one at least
    (3.9e-3 and 8.5e-3), so that the bounds would show a lost part of the
    mathematics."""
    for configs in (jax_swin2d._CONFIGS, backbone_swin2d._CONFIGS):
        monkeypatch.setitem(configs, "swin_l_p4w7", SWIN_L_CUT)
    jcfg = _jax_cfg("ytvos").replace(backbone="swin_l_p4w7", num_frames=T)
    jmodel, *_ = jax_build_model(jcfg)
    args = tuple(map(jnp.asarray, inputs))
    variables = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(9), *args, train=False))()
    j_out = jax.jit(lambda v: jmodel.apply(v, *args, train=False))(variables)
    cfg = dataclasses.replace(port_config(jcfg), compute_dtype=compute_dtype)
    model = build_model(cfg, device="cpu")
    assert model.backbone.embed_dim == 192 and model.backbone.num_frames == 1
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, variables))
    with torch.no_grad():
        t_out = model(*(torch.from_numpy(a) for a in inputs))
    logit, mask = _eval_gaps(t_out, j_out)
    within = logit <= LOGIT_ATOL and mask <= MASK_ATOL
    assert within == (compute_dtype == "float32"), (logit, mask)
