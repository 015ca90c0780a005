"""The yardstick's arithmetic: the card's peaks and the operations and bytes
that one call of each hand-written kernel's function needs, from its shapes.

Frozen copies of ``ocpg_tpu_torch/utils/hw.py`` (the H100 figures) and of
the shape-only counts of ``ocpg_tpu_torch/ops/ms_deform_attn.py`` and
``ops/window_attention.py``, so that a later change to the program cannot
move the bounds it is held to.  Bytes count each input read once and each
output written once; FLOPs count a multiply-add as two.
"""

from __future__ import annotations

from typing import Sequence, Tuple

# NVIDIA's data sheet, H100 SXM at 700 W: dense bf16 tensor-core FLOP/s, HBM bytes/s
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12

Shapes = Sequence[Tuple[int, int]]


def msda_fwd(shapes: Shapes, n: int, m: int, d: int, p: int, lq: int,
             es: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one MSDA forward: per sample 12 FLOPs for its
    coordinates and corner weights and, per corner (all four counted in the
    map), a weight product and a multiply-add per channel; the value (``es``
    bytes an element), x, y and the weights (float32) read once, the output
    written once."""
    samples = n * m * len(shapes) * p * lq
    s = sum(h * w for h, w in shapes)
    flops = samples * (4 * (2 * d + 2) + 12)
    nbytes = n * s * m * d * es + 3 * samples * 4 + n * lq * m * d * es
    return float(flops), float(nbytes)


def msda_bwd(shapes: Shapes, n: int, m: int, d: int, p: int, lq: int,
             es: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one MSDA backward: per corner and channel the
    multiply-add of sum_d g * v and the product added into d_value, per
    sample 40 for the coordinates, weights and d_x, d_y, d_aw; the value,
    the output's gradient, x, y and aw read once, d_value, d_x, d_y and
    d_aw written once."""
    samples = n * m * len(shapes) * p * lq
    s = sum(h * w for h, w in shapes)
    flops = samples * (4 * 4 * d + 40)
    nbytes = 2 * n * s * m * d * es + n * lq * m * d * es + 6 * samples * 4
    return float(flops), float(nbytes)


def wattn_fwd(bw: int, n: int, heads: int, dh: int, es: int,
              mask_windows) -> Tuple[float, float]:
    """(FLOPs, bytes) of one window-attention forward: the products q k^T
    and P v; q, k, v, the bias (and the mask) read once, the output written."""
    flops = 4 * bw * heads * n * n * dh
    nbytes = 4 * bw * n * heads * dh * es + heads * n * n * es
    if mask_windows:
        nbytes += mask_windows * n * n * es
    return float(flops), float(nbytes)


def wattn_bwd(bw: int, n: int, heads: int, dh: int, es: int,
              mask_windows) -> Tuple[float, float]:
    """(FLOPs, bytes) of one window-attention backward given the forward's
    inputs: P recomputed (q k^T), dP = dO v^T, dV = P^T dO, dQ = dS k,
    dK = dS^T q: five products; q, k, v, dO, the bias (and mask) read,
    dq, dk, dv and d_bias written."""
    flops = 10 * bw * heads * n * n * dh
    nbytes = 7 * bw * n * heads * dh * es + 2 * heads * n * n * es
    if mask_windows:
        nbytes += mask_windows * n * n * es
    return float(flops), float(nbytes)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
