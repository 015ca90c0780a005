"""Dense-CRF refinement of pseudo masks (the generator's optional stage):
the port's copy of ``ocpg_tpu/preprocess/dense_crf.py``, numpy on the host
as in the JAX package.

A mean-field dense CRF whose permutohedral lattice (pydensecrf in the
reference) is replaced by an explicit shifted-window evaluation of the two
standard kernels:
  * appearance (joint bilateral): w = exp(-|p|^2/2sxy_b^2 - |I_i-I_j|^2/2srgb^2)
  * smoothness (Gaussian):        w = exp(-|p|^2/2sxy_g^2)
Messages are kernel-normalised sums over the window without the centre
(sum_{j!=i} k(i,j) Q_j), and the Potts update adds the other labels'
messages to the unary energy: the Krahenbuhl-Koltun mean-field iteration.
``exact=True`` evaluates the fully connected model instead (O(N^2), for
small images: the oracle of the window's error).
"""

from __future__ import annotations

import numpy as np


def _potts_messages(img_f: np.ndarray, q: np.ndarray, radius: int,
                    sxy_gaussian: float, sxy_bilateral: float,
                    srgb_bilateral: float):
    """Kernel-normalized messages sum_{j!=i} k(i,j) q_j for each label.

    img_f: (H, W, 3) float; q: (K, H, W).  Returns (gauss_msg, bilat_msg),
    each (K, H, W) in [0, 1].
    """
    k, h, w = q.shape
    g_acc = np.zeros_like(q)
    g_norm = np.zeros((h, w), np.float32)
    b_acc = np.zeros_like(q)
    b_norm = np.zeros((h, w), np.float32)

    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dy == 0 and dx == 0:
                continue
            ys = slice(max(dy, 0), h + min(dy, 0))
            xs = slice(max(dx, 0), w + min(dx, 0))
            ys_s = slice(max(-dy, 0), h + min(-dy, 0))
            xs_s = slice(max(-dx, 0), w + min(-dx, 0))
            d2 = float(dx * dx + dy * dy)
            wg = np.exp(-d2 / (2.0 * sxy_gaussian ** 2))
            ws = np.exp(-d2 / (2.0 * sxy_bilateral ** 2))
            color = ((img_f[ys, xs] - img_f[ys_s, xs_s]) ** 2).sum(-1)
            wb = ws * np.exp(-color / (2.0 * srgb_bilateral ** 2))
            g_acc[:, ys, xs] += wg * q[:, ys_s, xs_s]
            g_norm[ys, xs] += wg
            b_acc[:, ys, xs] += wb * q[:, ys_s, xs_s]
            b_norm[ys, xs] += wb
    return g_acc / np.maximum(g_norm, 1e-12), b_acc / np.maximum(b_norm, 1e-12)


def _potts_messages_dense(img_f: np.ndarray, q: np.ndarray,
                          sxy_gaussian: float, sxy_bilateral: float,
                          srgb_bilateral: float):
    """The fully connected counterpart of ``_potts_messages``: O(N^2) over
    all pixel pairs, no window.  The same kernels, centre exclusion and
    per-pixel normalisation, evaluated against every j != i; for small
    images only (48 x 48 is 5.3M pairs)."""
    k, h, w = q.shape
    n = h * w
    yy, xx = np.mgrid[0:h, 0:w]
    pos = np.stack([yy.ravel(), xx.ravel()], 1).astype(np.float32)
    col = img_f.reshape(n, -1).astype(np.float32)
    d2 = ((pos[:, None] - pos[None]) ** 2).sum(-1)              # (N, N)
    kg = np.exp(-d2 / (2.0 * sxy_gaussian ** 2))
    c2 = ((col[:, None] - col[None]) ** 2).sum(-1)
    kb = np.exp(-d2 / (2.0 * sxy_bilateral ** 2) - c2 / (2.0 * srgb_bilateral ** 2))
    np.fill_diagonal(kg, 0.0)                                   # j != i
    np.fill_diagonal(kb, 0.0)
    qf = q.reshape(k, n)
    g = (qf @ kg) / np.maximum(kg.sum(axis=0), 1e-12)           # kernels are
    b = (qf @ kb) / np.maximum(kb.sum(axis=0), 1e-12)           # symmetric
    return g.reshape(k, h, w), b.reshape(k, h, w)


def _mean_field(image: np.ndarray, probs: np.ndarray, n_iters: int,
                radius: int, sxy_gaussian: float, compat_gaussian: float,
                sxy_bilateral: float, srgb_bilateral: float,
                compat_bilateral: float, exact: bool = False) -> np.ndarray:
    probs = probs.clip(1e-5, 1 - 1e-5).astype(np.float32)
    probs = probs / probs.sum(axis=0, keepdims=True)
    unary = -np.log(probs)
    q = probs.copy()
    img_f = image.astype(np.float32)
    for _ in range(n_iters):
        if exact:
            g_msg, b_msg = _potts_messages_dense(
                img_f, q, sxy_gaussian, sxy_bilateral, srgb_bilateral)
        else:
            g_msg, b_msg = _potts_messages(img_f, q, radius, sxy_gaussian,
                                           sxy_bilateral, srgb_bilateral)
        msg = compat_gaussian * g_msg + compat_bilateral * b_msg
        # Potts compatibility: pay for the mass of every OTHER label
        other = msg.sum(axis=0, keepdims=True) - msg
        energy = unary + other
        energy -= energy.min(axis=0, keepdims=True)
        q = np.exp(-energy)
        q /= q.sum(axis=0, keepdims=True)
    return q


def apply_dense_crf(image: np.ndarray, prob: np.ndarray, n_iters: int = 5,
                    radius: int = 5,
                    sxy_gaussian: float = 3.0, compat_gaussian: float = 3.0,
                    sxy_bilateral: float = 50.0, srgb_bilateral: float = 13.0,
                    compat_bilateral: float = 10.0,
                    exact: bool = False) -> np.ndarray:
    """Binary dense CRF.

    image: (H, W, 3) uint8 RGB; prob: (H, W) foreground probability in [0,1].
    Returns the refined (H, W) foreground probability.  ``exact=True``
    evaluates the fully connected pairwise model instead of the window.
    """
    q = _mean_field(image, np.stack([1.0 - prob, prob]), n_iters, radius,
                    sxy_gaussian, compat_gaussian, sxy_bilateral,
                    srgb_bilateral, compat_bilateral, exact=exact)
    return q[1]


def apply_dense_crf_multilabel(image: np.ndarray, probs: np.ndarray,
                               n_iters: int = 5, radius: int = 5) -> np.ndarray:
    """The multi-label variant. probs: (K, H, W)."""
    return _mean_field(image, probs, n_iters, radius, 3.0, 3.0, 50.0, 13.0, 10.0)
