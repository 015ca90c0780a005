"""Two forward-only reformulations of the channel-major MSDA forward, for
the MSDA kernel bench (``ocpg_tpu_torch/scripts/bench_msda_kernel.py``).

Counterparts of ``ocpg_tpu/ops/ms_deform_attn_pallas.py::
ms_deform_attn_pallas_cm_r4`` and ``::ms_deform_attn_pallas_cm_fk``.  Both
compute the function of ``ms_deform_attn.ms_deform_attn_cm`` (K1) with the
work put on the matrix unit instead of gathers:

* ``ms_deform_attn_cm_r4``, dense sampling rows: per query and level the
  row M_q[h * W + w] = sum_p aw * ry_p[h] * cx_p[w] over every key, then one
  product M @ V_l.  CUDA tensors launch ``csrc/ms_deform_attn_r4.cu`` (K5).
* ``ms_deform_attn_cm_fk``, separable hat rows with the levels fused on the
  contraction axis: A = [cx_0 | .. | cx_L-1] @ blockdiag(V'_l), then each A
  column (l, h, d) weighted by ry_l[h] * aw and summed over h, p and l.
  CUDA tensors launch ``csrc/ms_deform_attn_fk.cu`` (K6).

Each dispatches on the tensor's device: a CUDA tensor launches the kernel
or raises (no fallback), a CPU tensor runs the plain version
(``ms_deform_attn_cm_r4_reference``, ``ms_deform_attn_cm_fk_reference``),
which follows the formulation's algebra in the compute type (float32).  As
in the JAX package they have no gradient: the CUDA path raises on inputs
that require one.  The kernels round their tensor-core operands to
bfloat16 (the wrapper rounds a float32 value before the launch, as the JAX
wrappers do), accumulate in float32 and return the value's dtype; like K1
and the plain versions they sample nothing at a non-finite coordinate.
``r4_launches`` and ``fk_launches`` count the kernels' launches.

``r4_mma_flops`` and ``fk_mma_flops`` count the tensor-core FLOPs the two
kernels execute on given samples: the products they run, zeros included,
and not the ones they skip.
"""

from __future__ import annotations

import torch

from .ms_deform_attn import Shapes, _aligned, _call, _check, _check_cuda, _hat, _kernel

R4_SOURCE = "ms_deform_attn_r4.cu"
FK_SOURCE = "ms_deform_attn_fk.cu"
KERNEL_DIMS = (8, 16, 32, 64)   # D: a value row is one wgmma B row of 16-128 bytes
R4_TILE_Q = 256         # queries per K5 block (two warpgroups of 128 rows)
R4_CHUNK = 64           # keys per K5 product
FK_GROUP_ROWS = 64      # query rows per K6 warpgroup (two per block)
FK_COLS = 64            # A columns per K6 product block: 64 / D rows h
FK_MAX_K = 160          # sum_l W_l rounded up to 16: K6 keeps 4 points' cx_all rows in shared memory

# kernel launches since the last reset (set them to 0 to reset)
r4_launches = 0
fk_launches = 0


def _plain_inputs(value, spatial_shapes, x_cm, y_cm, aw_cm):
    """Per level: pixel coordinates (NM, P, Lq) with non-finite samples
    moved wholly outside the map and their weight zeroed, and the value
    rows (NM, H * W, D), in the compute type."""
    n, s, m, d = value.shape
    _, _, _, p, lq = x_cm.shape
    ct = torch.promote_types(value.dtype, torch.float32)
    v = value.to(ct).permute(0, 2, 1, 3).reshape(n * m, s, d)
    start = 0
    for lid, (h, w) in enumerate(spatial_shapes):
        x = x_cm[:, :, lid].to(ct).reshape(n * m, p, lq)
        y = y_cm[:, :, lid].to(ct).reshape(n * m, p, lq)
        finite = torch.isfinite(x) & torch.isfinite(y)
        xp = torch.where(finite, x, -2.0) * w - 0.5
        yp = torch.where(finite, y, -2.0) * h - 0.5
        a = aw_cm[:, :, lid].to(ct).reshape(n * m, p, lq).masked_fill(~finite, 0.0)
        yield (h, w), xp, yp, a, v[:, start:start + h * w]
        start += h * w


def _unfold(out, value):
    n, _, m, d = value.shape
    lq = out.shape[1]
    return out.reshape(n, m, lq, d).permute(0, 2, 1, 3).reshape(n, lq, m * d).to(value.dtype)


def ms_deform_attn_cm_r4_reference(value: torch.Tensor, spatial_shapes: Shapes,
                                   x_cm: torch.Tensor, y_cm: torch.Tensor,
                                   aw_cm: torch.Tensor) -> torch.Tensor:
    """Plain dense-row version: per level the (Lq, H * W) sampling matrix
    M = sum_p (aw * ry_p) (x) cx_p, then M @ V_l."""
    out = 0
    for (h, w), xp, yp, a, v_l in _plain_inputs(value, spatial_shapes, x_cm, y_cm, aw_cm):
        ry = _hat(yp, h) * a[..., None]                                  # (NM, P, Lq, H)
        rows = torch.einsum("bpqh,bpqw->bqhw", ry, _hat(xp, w))          # (NM, Lq, H, W)
        out = out + torch.bmm(rows.reshape(rows.shape[0], rows.shape[1], h * w), v_l)
    return _unfold(out, value)


def ms_deform_attn_cm_fk_reference(value: torch.Tensor, spatial_shapes: Shapes,
                                   x_cm: torch.Tensor, y_cm: torch.Tensor,
                                   aw_cm: torch.Tensor) -> torch.Tensor:
    """Plain fused-K version: per point A = cx_all @ blockdiag(V'_l) with
    V'_l (W, H * D), then each level's block of A weighted by ry * aw and
    summed over h; the sums over points and levels last."""
    levels = list(_plain_inputs(value, spatial_shapes, x_cm, y_cm, aw_cm))
    d = value.shape[3]
    nm, p, lq = levels[0][1].shape
    w_sum = sum(w for (_, w), *_ in levels)
    hd_sum = sum(h * d for (h, _), *_ in levels)
    vb = value.new_zeros((nm, w_sum, hd_sum), dtype=levels[0][4].dtype)
    k0 = c0 = 0
    for (h, w), _, _, _, v_l in levels:
        vb[:, k0:k0 + w, c0:c0 + h * d] = v_l.reshape(nm, h, w, d).transpose(1, 2).reshape(
            nm, w, h * d)
        k0, c0 = k0 + w, c0 + h * d
    out = 0
    for pi in range(p):
        cx_all = torch.cat([_hat(xp[:, pi], w) for (_, w), xp, *_ in levels], -1)
        a_all = torch.bmm(cx_all, vb)                                    # (NM, Lq, sum H*D)
        c0 = 0
        for (h, _), _, yp, a, _ in levels:
            ry = _hat(yp[:, pi], h) * a[:, pi, :, None]                  # (NM, Lq, H)
            a_l = a_all[:, :, c0:c0 + h * d].reshape(nm, lq, h, d)
            out = out + torch.einsum("bqhd,bqh->bqd", a_l, ry)
            c0 += h * d
    return _unfold(out, value)


def _launch(source, symbol, value, spatial_shapes, x_cm, y_cm, aw_cm):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (value, x_cm, y_cm, aw_cm)):
        raise RuntimeError(f"{symbol} is forward-only (no gradient, as in the JAX "
                           "package): call it under torch.no_grad() or on detached inputs")
    f32 = torch.float32
    _check_cuda(value, (("value", value, value.dtype), ("x_cm", x_cm, f32),
                        ("y_cm", y_cm, f32), ("aw_cm", aw_cm, f32)))
    n, _, m, d = value.shape
    out = torch.empty((n, x_cm.shape[-1], m * d), dtype=value.dtype, device=value.device)
    # the kernels read a bf16 value by TMA (16-byte aligned) and write the
    # value's dtype (_call passes it as the output's)
    v16 = _aligned(value.to(torch.bfloat16))
    _call(_kernel(source, symbol, 5), symbol, value, spatial_shapes, *x_cm.shape[-2:],
          (v16, x_cm, y_cm, aw_cm, out))
    return out


def ms_deform_attn_cm_r4(value: torch.Tensor, spatial_shapes: Shapes, x_cm: torch.Tensor,
                         y_cm: torch.Tensor, aw_cm: torch.Tensor) -> torch.Tensor:
    """Dense-row MSDA forward: K5 on CUDA tensors, the plain version on CPU
    tensors."""
    global r4_launches
    _check(value, spatial_shapes, x_cm, y_cm, aw_cm)
    if value.is_cuda:
        d, p = value.shape[3], x_cm.shape[3]
        if d not in KERNEL_DIMS or p > 8:
            raise ValueError(f"the r4 kernel takes D in {KERNEL_DIMS} and P <= 8, "
                             f"got D={d}, P={p}")
        out = _launch(R4_SOURCE, "msda_cm_r4_fwd", value, spatial_shapes, x_cm, y_cm, aw_cm)
        r4_launches += 1
        return out
    if value.device.type == "cpu":
        return ms_deform_attn_cm_r4_reference(value, spatial_shapes, x_cm, y_cm, aw_cm)
    raise ValueError(f"MSDA has no path for device {value.device}")


def ms_deform_attn_cm_fk(value: torch.Tensor, spatial_shapes: Shapes, x_cm: torch.Tensor,
                         y_cm: torch.Tensor, aw_cm: torch.Tensor) -> torch.Tensor:
    """Fused-K separable MSDA forward: K6 on CUDA tensors, the plain version
    on CPU tensors."""
    global fk_launches
    _check(value, spatial_shapes, x_cm, y_cm, aw_cm)
    if value.is_cuda:
        d = value.shape[3]
        k = -(-sum(w for _, w in spatial_shapes) // 16) * 16
        if d not in KERNEL_DIMS or k > FK_MAX_K:
            raise ValueError(f"the fk kernel takes D in {KERNEL_DIMS} and sum W_l up to "
                             f"{FK_MAX_K}, got D={d}, sum W_l={k}")
        out = _launch(FK_SOURCE, "msda_cm_fk_fwd", value, spatial_shapes, x_cm, y_cm, aw_cm)
        fk_launches += 1
        return out
    if value.device.type == "cpu":
        return ms_deform_attn_cm_fk_reference(value, spatial_shapes, x_cm, y_cm, aw_cm)
    raise ValueError(f"MSDA has no path for device {value.device}")


def _sample_cells(h, w, xn, yn):
    """Pixel corner (x0, y0) of each sample and whether the sample lies in
    the map (False at a non-finite coordinate), as the kernels decide it."""
    xp = xn * w - 0.5
    yp = yn * h - 0.5
    ok = (xp > -1) & (yp > -1) & (xp < w) & (yp < h)
    x0 = torch.where(ok, torch.floor(xp), 0.0).long()
    y0 = torch.where(ok, torch.floor(yp), 0.0).long()
    return ok, x0, y0


def r4_mma_flops(shapes: Shapes, x_cm: torch.Tensor, y_cm: torch.Tensor, dim: int) -> int:
    """Tensor-core FLOPs K5 executes on these samples: 2 x 128 x 64 x D for
    each (n, m, 128-query tile, level, 64-key chunk) that an in-map corner
    of a query of the tile lands in (both warpgroups multiply every chunk of
    their block; the kernel skips the other chunks)."""
    n, m, _, _, lq = x_cm.shape
    dev = x_cm.device
    nm = torch.arange(n * m, device=dev).reshape(n, m, 1, 1)
    tile = (torch.arange(lq, device=dev) // R4_TILE_Q).reshape(1, 1, 1, lq)
    n_tiles = -(-lq // R4_TILE_Q)
    chunks = 0
    for lid, (h, w) in enumerate(shapes):
        ok, x0, y0 = _sample_cells(h, w, x_cm[:, :, lid], y_cm[:, :, lid])
        n_chunks = -(-(h * w) // R4_CHUNK)
        ids = []
        for cx, cy in ((x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1, y0 + 1)):
            inside = ok & (cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1)
            cid = (nm * n_tiles + tile) * n_chunks + (cy * w + cx) // R4_CHUNK
            ids.append(cid[inside])
        chunks += torch.unique(torch.cat(ids)).numel()
    return chunks * 2 * R4_TILE_Q * R4_CHUNK * dim


def fk_mma_flops(shapes: Shapes, x_cm: torch.Tensor, y_cm: torch.Tensor, dim: int) -> int:
    """Tensor-core FLOPs K6 executes on these samples: 2 x 64 x 64 x 16 per
    K step of level l (the 16-deep steps that overlap its rows of cx_all)
    for each (n, m, point, 64 query rows, level, block of 64 A columns) in
    which some query of the 64 rows has an in-map sample whose y corner row
    h or h + 1 lies in the block (the kernel skips the other blocks)."""
    n, m, _, p, lq = x_cm.shape
    dev = x_cm.device
    hb = FK_COLS // dim
    nmp = torch.arange(n * m * p, device=dev).reshape(n, m, p, 1)
    rows = (torch.arange(lq, device=dev) // FK_GROUP_ROWS).reshape(1, 1, 1, lq)
    n_groups = -(-lq // FK_GROUP_ROWS)
    koff = steps = 0
    for lid, (h, w) in enumerate(shapes):
        ok, _, y0 = _sample_cells(h, w, x_cm[:, :, lid], y_cm[:, :, lid])
        n_blocks = -(-h // hb)
        ids = []
        for cy in (y0, y0 + 1):
            inside = ok & (cy >= 0) & (cy <= h - 1)
            ids.append(((nmp * n_groups + rows) * n_blocks + cy // hb)[inside])
        level_steps = -(-(koff + w) // 16) - koff // 16
        steps += torch.unique(torch.cat(ids)).numel() * level_steps
        koff += w
    return steps * 2 * FK_GROUP_ROWS * FK_COLS * 16
