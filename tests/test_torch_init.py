"""The port's random init against the JAX package's initialisers, on the CPU.

``build_model`` (``init_modules`` for a bare backbone) with a seeded
generator, beside two real JAX inits (keys 0 and 1) of the same config: the
small ResNet-50 model of tests/test_torch_model.py, the ``video_swin_test``
model, and the 2D Swin backbone at tests/test_torch_swin.py's small widths.
Per leaf, by the JAX tree's names carried to the port's keys:

* the same names and shapes;
* the Swin patch embedding's bias, zeros in JAX, uniform within
  1/sqrt(fan_in) in the port, as in the reference (a zero bias makes the
  canvas padding's tokens constant vectors, whose LayerNorm backward
  scales by 1/sqrt(eps): the last test shows JAX's gradient blow up there);
* a leaf that both JAX keys draw the same (biases, norms, the MSDA offset
  grid, the class prior) equal in the port;
* every other leaf: the initialiser JAX drew it from is read off its draw
  (lecun-normal or xavier-uniform for a kernel by its fans, N(0, 1/features)
  for an embedding, N(0, 1) or the truncated N(0, 0.02^2) else; the
  candidate whose std the draw matches within 6 standard errors and whose
  cut it respects, the tightest cut first).  The port's draw respects the
  same cut (2.27/sqrt(fan_in) for lecun-normal, sqrt(6/(fan_in + fan_out))
  for xavier), and, for leaves of at least 256 entries, has that std within
  6 standard errors (6/sqrt(2n) relative) and the same law as JAX's draw:
  the two-sample Kolmogorov-Smirnov distance under 2.69 sqrt((n+m)/nm),
  the 1e-6 level (that tells a square xavier kernel from a lecun one).
"""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ocpg_tpu.models import backbone_video_swin as jax_swin
from ocpg_tpu.models import build_model as jax_build_model

from ocpg_tpu_torch.data.synthetic import synthetic_batch
from ocpg_tpu_torch.models import backbone_video_swin
from ocpg_tpu_torch.models.build import build_model, init_modules
from ocpg_tpu_torch.utils.weights import _port_key

from tests.test_torch_model import _jax_cfg, port_config
from tests.test_torch_swin import SMALL

T, H, W, LT = 2, 64, 64, 8
TRUNC_STD = 0.87962566103423978     # std of N(0, 1) cut at +-2
KS_C = 2.69                         # two-sample KS critical value at the 1e-6 level


def _flat(variables):
    """Port key -> (JAX leaf name, JAX shape, array in the port's layout)."""
    out = {}
    for collection in ("params", "frozen"):
        leaves = jax.tree_util.tree_flatten_with_path(variables.get(collection, {}))[0]
        for path, arr in leaves:
            names = tuple(str(getattr(p, "key", p)) for p in path)
            arr = np.asarray(arr, np.float32)
            key, port = _port_key(names, arr)
            out[key] = (names[-1], arr.shape, port)
    return out


def _candidates(leaf, shape):
    """(name, std, cut) of the JAX initialisers a leaf can come from."""
    if leaf == "kernel":
        field = math.prod(shape[:-2])
        fan_in, fan_out = shape[-2] * field, shape[-1] * field
        return [("lecun_normal", 1 / math.sqrt(fan_in), 2 / TRUNC_STD / math.sqrt(fan_in)),
                ("xavier_uniform", math.sqrt(2 / (fan_in + fan_out)),
                 math.sqrt(6 / (fan_in + fan_out)))]
    if leaf == "embedding":
        return [("default_embed_init", 1 / math.sqrt(shape[-1]), math.inf)]
    return [("normal(1)", 1.0, math.inf), ("truncated_normal(0.02)", 0.02 * TRUNC_STD, 0.04)]


def _rms(x):
    return float(np.sqrt(np.mean(np.square(x, dtype=np.float64))))


def _ks(a, b):
    a, b = np.sort(a.ravel()), np.sort(b.ravel())
    grid = np.concatenate([a, b])
    return float(np.abs(np.searchsorted(a, grid, "right") / a.size
                        - np.searchsorted(b, grid, "right") / b.size).max())


def _check(port_state, jax_draws):
    want, other = (_flat(v) for v in jax_draws)
    got = {k: v.detach().numpy() for k, v in port_state.items()}
    assert sorted(got) == sorted(want)
    n_random = 0
    for key, (leaf, jshape, ref) in want.items():
        x = got[key]
        assert x.shape == ref.shape, key
        if key.endswith("patch_embed.bias"):
            # the port's one departure (test_padded_swin_gradient_stays_finite_...): the
            # reference's U(+-1/sqrt(fan_in)) where JAX has zeros
            assert not ref.any(), key
            fan_in = math.prod(want[key[:-4] + "weight"][1][:-1])
            assert 0 < np.abs(x).max() <= fan_in ** -0.5, key
            continue
        if np.array_equal(ref, other[key][2]):
            np.testing.assert_array_equal(x, ref, err_msg=key)
            continue
        n_random += 1
        n, rel = ref.size, 6 / math.sqrt(2 * ref.size)
        fits = [(cut, name, std) for name, std, cut in _candidates(leaf, jshape)
                if np.abs(ref).max() <= cut * (1 + 1e-6) and abs(_rms(ref) / std - 1) <= rel]
        assert fits, f"{key}: no JAX initialiser fits JAX's own draw"
        cut, name, std = min(fits)
        assert np.abs(x).max() <= cut * (1 + 1e-6), (key, name, np.abs(x).max(), cut)
        if n >= 256:
            assert abs(_rms(x) / std - 1) <= rel, (key, name, _rms(x), std)
            assert _ks(x, ref) <= KS_C * math.sqrt(2 / n), (key, name, _ks(x, ref))
    return n_random


def _model_draws(jcfg):
    jmodel, *_ = jax_build_model(jcfg)
    batch = synthetic_batch(np.random.default_rng(0), batch=1, frames=T, height=H, width=W,
                            text_len=LT, vocab_size=jcfg.text_vocab)
    args = tuple(jnp.asarray(batch[k]) for k in
                 ("samples", "samples_mask", "text_ids", "text_mask")) + (
        jnp.asarray(batch["targets"]["size"]),)
    targets = jax.tree_util.tree_map(jnp.asarray, batch["targets"])
    init = jax.jit(lambda key: jmodel.init(key, *args, targets=targets, train=True))
    return [init(jax.random.PRNGKey(s)) for s in (0, 1)]


@pytest.mark.parametrize("backbone", ["resnet50", "video_swin_test"])
def test_build_model_draws_from_the_jax_initialisers(backbone):
    jcfg = _jax_cfg("ytvos").replace(backbone=backbone, num_frames=T)
    model = build_model(port_config(jcfg), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    assert _check(model.state_dict(), _model_draws(jcfg)) > 100


def test_swin2d_backbone_draws_from_the_jax_initialisers():
    kw = dict(window_size=(1, 7, 7), num_frames=1, **SMALL)
    jmod = jax_swin.VideoSwin(**kw)
    frames = jnp.zeros((1, 64, 64, 3))
    init = jax.jit(lambda key: jmod.init(key, frames))
    draws = [init(jax.random.PRNGKey(s)) for s in (0, 1)]
    port = backbone_video_swin.VideoSwin(**kw)
    init_modules(port, torch.Generator().manual_seed(0))
    assert _check(port.state_dict(), draws) > 10


def test_padded_swin_gradient_stays_finite_where_jax_zero_bias_overflows():
    """The fault the port's patch-embedding bias repairs, on the Swin-T
    backbone (depths cut to 2 a stage) over a 2-frame clip whose right half
    is canvas padding (zeros, as the loader pads): with JAX's init the
    padded tokens are zero vectors, every LayerNorm over a wholly padded
    window has no variance and scales its backward by 1/sqrt(eps) = 1000,
    and d(sum w * features)/d(patch_embed bias) overflows float32.  With
    JAX's tree carried over the port computes the same (the bias gradient
    infinite, the kernel's equal to JAX's); its own init keeps the bias
    gradient finite, at the scale of the kernel's."""
    from tests.test_torch_swin import SWIN_T_CUT
    from ocpg_tpu_torch.utils.weights import load_jax_params

    rng = np.random.default_rng(0)
    frames = rng.standard_normal((2, 64, 128, 3)).astype(np.float32)
    frames[:, :, 64:] = 0.0
    jmod = jax_swin.VideoSwin(num_frames=2, **SWIN_T_CUT)
    variables = jax.jit(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(frames)))()
    feats = jax.eval_shape(lambda: jmod.apply(variables, jnp.asarray(frames)))
    weights = [rng.standard_normal(f.shape).astype(np.float32) for f in feats]

    def jax_loss(params):
        out = jmod.apply({"params": params}, jnp.asarray(frames))
        return sum(jnp.sum(o * w) for o, w in zip(out, weights))

    jgrad = jax.jit(jax.grad(jax_loss))(variables["params"])
    jax_bias = float(jnp.linalg.norm(jgrad["patch_embed"]["bias"]))
    jax_kernel = float(jnp.linalg.norm(jgrad["patch_embed"]["kernel"]))

    def port_bias_grad(port):
        x = torch.from_numpy(frames).permute(0, 3, 1, 2)
        out = port(x, num_frames=2)
        loss = sum((o.permute(0, 2, 3, 1) * torch.from_numpy(w)).sum()
                   for o, w in zip(out, weights))
        loss.backward()
        return float(port.patch_embed.bias.grad.norm()), float(port.patch_embed.weight.grad.norm())

    carried = backbone_video_swin.VideoSwin(**SWIN_T_CUT).eval()
    assert load_jax_params(carried, jax.tree_util.tree_map(np.asarray, variables)) == []
    carried_bias, carried_weight = port_bias_grad(carried)
    own = backbone_video_swin.VideoSwin(**SWIN_T_CUT).eval()
    init_modules(own, torch.Generator().manual_seed(0))
    own_bias, own_weight = port_bias_grad(own)
    assert not math.isfinite(jax_bias) and not math.isfinite(carried_bias)
    np.testing.assert_allclose(carried_weight, jax_kernel, rtol=1e-4)
    assert math.isfinite(own_bias) and own_bias < 10 * own_weight
