"""Per-module parity of the PyTorch port against the JAX package, on the CPU.

Every flax module gets seeded-noise variables (only their shapes come from
init), which ``load_jax_params`` carries into the port's module by name;
inputs are made with numpy and go through both.  Everything runs in
float32.  Tolerances, relative to the largest |output|:

* 1e-5 for single ops and shallow layers (the two frameworks order float32
  sums differently, a few ulps);
* 1e-4 for deep stacks (ResNet-50, RoBERTa, LFM's FFT round trip, the
  deformable transformer), where those differences compound through layers.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ocpg_tpu.models import backbone_resnet as j_backbone
from ocpg_tpu.models import cross_modal as j_cross
from ocpg_tpu.models import deformable_transformer as j_dt
from ocpg_tpu.models import layers as j_layers
from ocpg_tpu.models import mask_head as j_mask
from ocpg_tpu.models import position_encoding as j_pos
from ocpg_tpu.models import text_encoder as j_text
from ocpg_tpu.ops import image as j_image

from ocpg_tpu_torch.models import backbone_resnet as p_backbone
from ocpg_tpu_torch.models import cross_modal as p_cross
from ocpg_tpu_torch.models import deformable_transformer as p_dt
from ocpg_tpu_torch.models import layers as p_layers
from ocpg_tpu_torch.models import mask_head as p_mask
from ocpg_tpu_torch.models import position_encoding as p_pos
from ocpg_tpu_torch.models import text_encoder as p_text
from ocpg_tpu_torch.ops import image as p_image
from ocpg_tpu_torch.utils.weights import load_jax_params

SHALLOW = 1e-5
DEEP = 1e-4


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-6)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol)


def _nchw(x):
    return torch.from_numpy(np.array(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


def _carry(jmodule, pmodule, *args, seed=0, std=0.05, **kwargs):
    """Noise variables for ``jmodule`` (shapes from init on ``args``), loaded
    into ``pmodule``; returns the variables."""
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.default_rng(seed)

    def fill(path, x):
        if str(getattr(path[-1], "key", path[-1])) == "running_var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (rng.standard_normal(x.shape) * std).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    load_jax_params(pmodule, variables)
    return variables


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------ ops/image.py --
@pytest.mark.parametrize("size_in,size_out", [
    ((12, 20), (48, 80)), ((96, 160), (24, 40)), ((7, 5), (3, 9)), ((6, 10), (6, 10)),
    ((10, 7), (23, 16))])
def test_resizes_match_jax(size_in, size_out):
    rng = np.random.default_rng(0)
    x = _randn(rng, 2, *size_in, 3)
    xt = _nchw(x)
    mask = (rng.random((2, *size_in, 1)) > 0.5).astype(np.float32)
    _close(_nhwc(p_image.nearest_resize(_nchw(mask), size_out)),
           j_image.nearest_resize(jnp.asarray(mask), size_out), 0.0)
    _close(_nhwc(p_image.bilinear_resize(xt, size_out)),
           j_image.bilinear_resize(jnp.asarray(x), size_out), SHALLOW)
    # align_corners=True (the train path's level-set features and loss):
    # both sides build the matrices in float64 and apply them in float32
    _close(_nhwc(p_image.bilinear_resize(xt, size_out, align_corners=True)),
           j_image.bilinear_resize(jnp.asarray(x), size_out, align_corners=True), SHALLOW)
    _close(_nhwc(p_image.bicubic_resize(xt, size_out)),
           j_image.bicubic_resize(jnp.asarray(x), size_out), SHALLOW)


@pytest.mark.parametrize("size_in,size_out", [((12, 20), (48, 80)), ((10, 7), (23, 16))])
def test_align_corners_resize_matches_jax_in_bfloat16(size_in, size_out):
    """bf16 operands with float32 accumulation, rounded to bf16 after each
    of the two passes on both sides: 1e-2 of max |out| (a few bf16 ulps)."""
    x = _randn(np.random.default_rng(13), 2, *size_in, 3)
    got = p_image.bilinear_resize(_nchw(x).bfloat16(), size_out, align_corners=True)
    assert got.dtype == torch.bfloat16
    want = j_image.bilinear_resize(jnp.asarray(x, jnp.bfloat16), size_out, align_corners=True)
    _close(_nhwc(got.float()), np.asarray(want, np.float32), 1e-2)


# the memory-fusion calls (models/ocpg.py): levels at strides 16, 32 and 64
# resized to stride 8, at the 384x640 serving bucket and the 512x640 train clip
MEMORY_FUSION_CALLS = [((24, 40), (48, 80)), ((12, 20), (48, 80)), ((6, 10), (48, 80)),
                       ((32, 40), (64, 80)), ((16, 20), (64, 80)), ((8, 10), (64, 80))]


@pytest.mark.parametrize("mode", ["bicubic", "bilinear"])
@pytest.mark.parametrize("call", range(len(MEMORY_FUSION_CALLS)))
def test_memory_fusion_resize_matches_jax_in_bfloat16(mode, call):
    """bf16 resize of seeded standard-normal (5, 256, h, w) inputs against the
    JAX function, within 1e-2 of max |out|.  Both round the matrices to
    bf16, accumulate each pass in float32 and round to bf16 between the H
    and the W pass: measured 0 at every call but bicubic (8, 10) -> (64, 80),
    1.6e-3 (one bf16 rounding tie).  F.interpolate's bicubic, which rounds
    once, read 6.1e-3 to 1.26e-2 here (four of the six calls above 1e-2);
    its bilinear 3.5e-3 to 6.7e-3."""
    size_in, size_out = MEMORY_FUSION_CALLS[call]
    x = _randn(np.random.default_rng(call), 5, *size_in, 256)
    got = getattr(p_image, f"{mode}_resize")(_nchw(x).bfloat16(), size_out)
    assert got.dtype == torch.bfloat16
    want = getattr(j_image, f"{mode}_resize")(jnp.asarray(x, jnp.bfloat16), size_out)
    _close(_nhwc(got.float()), np.asarray(want, np.float32), 1e-2)


@pytest.mark.parametrize("dtype,tol", [("float32", SHALLOW), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("size_in,size_out", [((12, 20), (48, 80)), ((10, 7), (23, 16))])
def test_bicubic_resize_gradient_matches_jax(dtype, tol, size_in, size_out):
    """The bicubic resize's gradient (autograd through the two products)
    against jax.vjp of the JAX function: measured 2.3e-7 of max |grad| in
    float32 and 0 in bf16."""
    rng = np.random.default_rng(17)
    x = _randn(rng, 2, *size_in, 4)
    g = _randn(rng, 2, *size_out, 4)
    jd = getattr(jnp, dtype)
    _, vjp = jax.vjp(lambda a: j_image.bicubic_resize(a, size_out), jnp.asarray(x, jd))
    want = vjp(jnp.asarray(g, jd))[0]
    xt = _nchw(x).to(getattr(torch, dtype)).requires_grad_()
    p_image.bicubic_resize(xt, size_out).backward(_nchw(g).to(xt.dtype))
    assert xt.grad.dtype == xt.dtype
    _close(_nhwc(xt.grad.float()), np.asarray(want, np.float32), tol)


def test_pixel_shuffle_matches_jax():
    x = _randn(np.random.default_rng(1), 2, 3, 5, 16)
    _close(_nhwc(p_image.pixel_shuffle(_nchw(x), 4)),
           j_image.pixel_shuffle(jnp.asarray(x), 4), 0.0)


# ---------------------------------------------------------- models/layers --
def test_mlp_and_feature_resizer_match_jax():
    rng = np.random.default_rng(2)
    x = _randn(rng, 3, 7, 24)
    pm = p_layers.MLP(24, 32, 5, 3)
    v = _carry(j_layers.MLP(32, 5, 3), pm, jnp.asarray(x))
    _close(pm(torch.from_numpy(x)), j_layers.MLP(32, 5, 3).apply(v, jnp.asarray(x)), SHALLOW)
    pf = p_layers.FeatureResizer(24, 16).eval()       # dropout off, as deterministic=True
    v = _carry(j_layers.FeatureResizer(16), pf, jnp.asarray(x), std=0.3)
    _close(pf(torch.from_numpy(x)), j_layers.FeatureResizer(16).apply(v, jnp.asarray(x)),
           SHALLOW)


def test_frozen_batchnorm_matches_jax():
    x = _randn(np.random.default_rng(3), 2, 5, 6, 8)
    pb = p_layers.FrozenBatchNorm(8)
    v = _carry(j_layers.FrozenBatchNorm(8), pb, jnp.asarray(x), std=1.0)
    _close(_nhwc(pb(_nchw(x))), j_layers.FrozenBatchNorm(8).apply(v, jnp.asarray(x)),
           SHALLOW)


def test_multihead_attention_matches_jax():
    rng = np.random.default_rng(4)
    q, k = _randn(rng, 2, 9, 32), _randn(rng, 2, 6, 32)
    pad = np.zeros((2, 6), bool)
    pad[0, -2:] = True
    jm = j_layers.MultiheadAttention(4)
    pm = p_layers.MultiheadAttention(32, 4)
    args = [jnp.asarray(a) for a in (q, k, k, pad)]
    v = _carry(jm, pm, *args, std=0.3)
    _close(pm(*(torch.from_numpy(a) for a in (q, k, k, pad))), jm.apply(v, *args), SHALLOW)


def test_inverse_sigmoid_matches_jax():
    x = np.linspace(-0.2, 1.2, 57).astype(np.float32)
    _close(p_layers.inverse_sigmoid(torch.from_numpy(x)),
           j_layers.inverse_sigmoid(jnp.asarray(x)), SHALLOW)


# ------------------------------------------------- models/position_encoding --
def test_position_encodings_match_jax():
    mask2 = np.zeros((2, 6, 9), bool)
    mask2[0, :, -3:] = True
    mask2[1, -2:, :] = True
    _close(p_pos.position_embedding_sine_2d(torch.from_numpy(mask2), 16),
           j_pos.position_embedding_sine_2d(jnp.asarray(mask2), 16), SHALLOW)
    mask1 = np.zeros((2, 8), bool)
    mask1[1, -3:] = True
    _close(p_pos.position_embedding_sine_1d(torch.from_numpy(mask1), 32),
           j_pos.position_embedding_sine_1d(jnp.asarray(mask1), 32), SHALLOW)


# --------------------------------------------------- models/backbone_resnet --
def test_resnet50_matches_jax():
    x = _randn(np.random.default_rng(5), 2, 64, 96, 3)
    jm = j_backbone.build_resnet("resnet50", False)
    pm = p_backbone.build_resnet("resnet50", False)
    v = _carry(jm, pm, jnp.asarray(x))
    want = jm.apply(v, jnp.asarray(x))
    got = pm(_nchw(x))
    assert len(got) == 4
    for g, w in zip(got, want):
        _close(_nhwc(g), w, DEEP)


# ------------------------------------------------------ models/text_encoder --
def test_roberta_matches_jax():
    rng = np.random.default_rng(6)
    cfg_kw = dict(vocab_size=300, hidden_size=64, num_layers=2, num_heads=4,
                  intermediate_size=128, max_position_embeddings=40)
    ids = rng.integers(4, 299, (2, 10)).astype(np.int32)
    mask = np.ones((2, 10), np.int32)
    ids[0, 7:], mask[0, 7:] = 1, 0
    jm = j_text.RobertaEncoder(j_text.RobertaConfig(**cfg_kw))
    pm = p_text.RobertaEncoder(p_text.RobertaConfig(**cfg_kw))
    v = _carry(jm, pm, jnp.asarray(ids), jnp.asarray(mask), std=0.2)
    want_h, want_p = jm.apply(v, jnp.asarray(ids), jnp.asarray(mask))
    got_h, got_p = pm(torch.from_numpy(ids), torch.from_numpy(mask))
    _close(got_h, want_h, DEEP)
    _close(got_p, want_p, DEEP)


def test_tokenizer_ids_match_jax():
    caps = ["a man riding a horse", "The Dog on the LEFT jumps", "",
            " ".join(f"w{i}" for i in range(40))]
    for kw in (dict(max_len=16), dict(max_len=32, vocab_size=1000)):
        want = j_text.SimpleTokenizer(**kw)(caps)
        got = p_text.SimpleTokenizer(**kw)(caps)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(NotImplementedError):
        p_text.SimpleTokenizer(checkpoint_path="roberta-base")


# ------------------------------------------------------- models/cross_modal --
@pytest.mark.parametrize("hw", [(12, 20), (2, 3)])
def test_lfm_matches_jax(hw):
    """(2, 3) is smaller than the 3x3 Laplace kernel: VALID falls back to SAME."""
    rng = np.random.default_rng(7)
    x = _randn(rng, 2, *hw, 8)
    jm = j_cross.LFM(8)
    pm = p_cross.LFM(8)
    v = _carry(jm, pm, jnp.asarray(x), std=0.2)
    want, want_g = jm.apply(v, jnp.asarray(x))
    got, got_g = pm(_nchw(x))
    _close(_nhwc(got), want, DEEP)
    _close(_nhwc(got_g), want_g, SHALLOW)
    # a Gaussian from a larger level, bilinearly resized
    g0 = j_cross.make_gaussian(24, 40, 7.0)
    want, want_g = jm.apply(v, jnp.asarray(x), g0)
    got, got_g = pm(_nchw(x), _nchw(g0))
    _close(_nhwc(got), want, DEEP)
    _close(_nhwc(got_g), want_g, SHALLOW)


def test_vision_language_fusion_matches_jax():
    rng = np.random.default_rng(8)
    vis, text, pos = _randn(rng, 2, 30, 32), _randn(rng, 2, 6, 32), _randn(rng, 2, 6, 32)
    pad = np.zeros((2, 6), bool)
    pad[1, -3:] = True
    jm = j_cross.VisionLanguageFusion(4)
    pm = p_cross.VisionLanguageFusion(32, 4)
    args = [jnp.asarray(a) for a in (vis, text, pad, pos)]
    v = _carry(jm, pm, *args, std=0.3)
    _close(pm(*(torch.from_numpy(a) for a in (vis, text, pad, pos))), jm.apply(v, *args),
           SHALLOW)


# -------------------------------------------- models/deformable_transformer --
SHAPES = ((8, 10), (4, 5), (2, 3), (1, 2))


def _level_masks():
    masks = []
    for h, w in SHAPES:
        m = np.zeros((2, h, w), bool)
        m[0, :, w - max(1, w // 4):] = w > 1
        m[1, h - max(1, h // 4):, :] = h > 1
        masks.append(m)
    return masks


def test_valid_ratio_and_encoder_reference_points_match_jax():
    masks = _level_masks()
    want_vr = jnp.stack([j_dt.get_valid_ratio(jnp.asarray(m)) for m in masks], 1)
    got_vr = torch.stack([p_dt.get_valid_ratio(torch.from_numpy(m)) for m in masks], 1)
    _close(got_vr, want_vr, 0.0)
    _close(p_dt.encoder_reference_points(SHAPES, got_vr),
           j_dt.encoder_reference_points(SHAPES, want_vr), SHALLOW)


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_msdeform_attn_module_matches_jax(ref_dim):
    rng = np.random.default_rng(9)
    s = sum(h * w for h, w in SHAPES)
    query, src = _randn(rng, 2, 7, 64), _randn(rng, 2, s, 64)
    ref = rng.random((2, 7, len(SHAPES), ref_dim)).astype(np.float32)
    pad = np.concatenate([m.reshape(2, -1) for m in _level_masks()], 1)
    jm = j_dt.MSDeformAttnModule(64, len(SHAPES), 8, 4)
    pm = p_dt.MSDeformAttnModule(64, len(SHAPES), 8, 4)
    args = [jnp.asarray(a) for a in (query, ref, src)]
    v = _carry(jm, pm, *args, SHAPES, jnp.asarray(pad), std=0.2)
    want = jm.apply(v, *args, SHAPES, jnp.asarray(pad))[0]
    got = pm(*(torch.from_numpy(a) for a in (query, ref, src)), SHAPES, torch.from_numpy(pad))
    _close(got, want, SHALLOW)


def test_deformable_transformer_matches_jax():
    rng = np.random.default_rng(10)
    d = 64
    srcs = [_randn(rng, 2, h, w, d) for h, w in SHAPES]
    poses = [_randn(rng, 2, h, w, d) for h, w in SHAPES]
    masks = _level_masks()
    tgt, qe = _randn(rng, 2, 5, d), _randn(rng, 5, d)
    kw = dict(d_model=d, nhead=8, num_encoder_layers=2, num_decoder_layers=2,
              dim_feedforward=32, num_feature_levels=len(SHAPES))
    jm = j_dt.DeformableTransformer(**kw)
    pm = p_dt.DeformableTransformer(**kw).eval()      # dropout off, as deterministic=True
    jargs = ([jnp.asarray(a) for a in srcs], jnp.asarray(tgt),
             [jnp.asarray(m) for m in masks], [jnp.asarray(p) for p in poses],
             jnp.asarray(qe))
    v = _carry(jm, pm, *jargs, std=0.1)
    want = jm.apply(v, *jargs)
    got = pm([_nchw(a) for a in srcs], torch.from_numpy(tgt),
             [torch.from_numpy(m) for m in masks], [torch.from_numpy(p) for p in poses],
             torch.from_numpy(qe))
    for k in ("hs", "init_reference", "inter_references", "inter_coords"):
        _close(got[k], want[k], DEEP)
    for g, w in zip(got["memory_features"], want["memory_features"]):
        _close(_nhwc(g), w, DEEP)


# --------------------------------------------------------- models/mask_head --
def test_dynamic_conv_helpers_match_jax():
    assert p_mask.dynamic_params_layout(256, 16, 2, True) == \
        j_mask.dynamic_params_layout(256, 16, 2, True)
    _close(p_mask.compute_locations(6, 9, 8), j_mask.compute_locations(6, 9, 8), 0.0)
    rng = np.random.default_rng(11)
    for rel_coord in (True, False):
        wn, bn = j_mask.dynamic_params_layout(24, 16, 2, rel_coord)
        mem, rel = _randn(rng, 3, 5, 6, 24), _randn(rng, 3, 4, 5, 6, 2)
        params = _randn(rng, 3, 4, sum(wn) + sum(bn)) * 0.3
        want = j_mask.apply_dynamic_conv_shared(*map(jnp.asarray, (mem, rel, params)),
                                                16, wn, bn)
        got = p_mask.apply_dynamic_conv_shared(*map(torch.from_numpy, (mem, rel, params)),
                                               16, wn, bn)
        _close(got, want, SHALLOW)


@pytest.mark.parametrize("queries", [1, 3])
def test_mso_matches_jax(queries):
    rng = np.random.default_rng(12)
    g = 2
    pred = _randn(rng, g * queries, 5, 6, 16)
    f4, f8 = _randn(rng, g, 10, 12, 24), _randn(rng, g, 5, 6, 40)
    jm = j_mask.MSO(16, (24, 40))
    pm = p_mask.MSO(16, (24, 40))
    args = [jnp.asarray(a) for a in (pred, f4, f8)]
    v = _carry(jm, pm, *args, queries, std=0.1)
    want = jm.apply(v, *args, queries)
    got = pm(*(_nchw(a) for a in (pred, f4, f8)), queries)
    _close(_nhwc(got), want, SHALLOW)
