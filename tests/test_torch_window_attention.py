"""The port's Swin window attention (``ocpg_tpu_torch/ops/window_attention.py``)
against the JAX package's, on the CPU.

The plain version is held against ``window_attention_xla`` in float32 at
1e-5 (the same sums in another order), and against the Pallas kernel
``window_attention_fused`` in interpret mode at the 2e-2 bound of
tests/test_window_attention_pallas.py (that kernel computes its products
in bfloat16).  The backward rule (autograd through the plain version) is
held against ``_wattn_bwd``, the JAX custom VJP's XLA recompute, at 1e-5.
The CUDA kernel itself runs only on the card (``chip_smoke.py`` phase
``kernel``).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ocpg_tpu.ops.window_attention_pallas import (_wattn_bwd, window_attention_fused,
                                                  window_attention_xla)

from ocpg_tpu_torch.ops import window_attention as wattn

CASES = {   # name: (bw, n, heads, dh, windows of the mask or None)
    "n13": (6, 13, 2, 8, None),
    "n49_wide": (4, 49, 8, 32, None),        # heads x dh = 256 > 128
    "n49_mask": (6, 49, 2, 8, 3),
}


def _inputs(case, seed=0):
    bw, n, h, dh, nw = CASES[case]
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((bw, n, h, dh)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((bw, n, h, dh)) * 0.5).astype(np.float32)
    v = rng.standard_normal((bw, n, h, dh)).astype(np.float32)
    bias = (rng.standard_normal((h, n, n)) * 0.1).astype(np.float32)
    mask = None
    if nw is not None:   # a distinct -100 block structure per window
        mask = np.zeros((nw, n, n), np.float32)
        for w in range(nw):
            cut = 10 + 9 * w
            mask[w, :cut, cut:] = -100.0
            mask[w, cut:, :cut] = -100.0
    return q, k, v, bias, mask


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_xla(case):
    arrays = _inputs(case)
    want = window_attention_xla(*_jax(*arrays), jnp.float32)
    got = wattn.window_attention_reference(*_torch(*arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["n13", "n49_mask"])
def test_plain_matches_interpreted_pallas(case):
    arrays = _inputs(case, seed=1)
    want = window_attention_fused(*_jax(*arrays), True)
    got = wattn.window_attention_reference(*_torch(*arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("case", ["n13", "n49_mask"])
def test_backward_rule_matches_jax_custom_vjp(case):
    arrays = _inputs(case, seed=2)
    g = np.random.default_rng(3).standard_normal(arrays[0].shape).astype(np.float32)
    want = _wattn_bwd(jnp.float32, tuple(_jax(*arrays)), jnp.asarray(g))
    if arrays[4] is None:
        assert want[4] is None             # no mask cotangent
    got = wattn.window_attention_grad_reference(*_torch(*arrays), torch.from_numpy(g))
    for name, a, b in zip(("d_q", "d_k", "d_v", "d_bias"), got, want[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_cpu_dispatch_runs_the_plain_version_on_qkv_slices():
    """The Swin module hands over k and v as slices of the qkv projection;
    a CPU tensor takes the plain version and launches nothing."""
    q, k, v, bias, mask = _torch(*_inputs("n49_mask", seed=4))
    qkv = torch.stack([q, k, v], 2)                     # (bw, n, 3, h, dh)
    wattn.launches = 0
    got = wattn.window_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], bias, mask)
    assert wattn.launches == 0
    torch.testing.assert_close(got, wattn.window_attention_reference(q, k, v, bias, mask),
                               rtol=0, atol=0)
    low = wattn.window_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), bias, mask)
    assert low.dtype == torch.bfloat16


def test_shapes_and_kernel_limits_are_checked():
    q, k, v, bias, mask = _torch(*_inputs("n49_mask"))
    with pytest.raises(ValueError, match="nW dividing"):
        wattn.window_attention(q, k, v, bias, torch.cat([mask, mask[:1]]))
    with pytest.raises(ValueError, match="bias"):
        wattn.window_attention(q, k, v, bias[:, :48], None)
    big = torch.zeros(1, wattn.MAX_N + 1, 1, 32)
    with pytest.raises(ValueError, match="n <= 392"):
        wattn._launch(big, big, big, torch.zeros(1, 393, 393), None)
    # a CPU tensor never reaches the kernel
    with pytest.raises(ValueError, match="is on cpu"):
        wattn._launch(q, k, v, bias, mask)
