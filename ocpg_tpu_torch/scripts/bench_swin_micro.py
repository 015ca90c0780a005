"""Microbench of the Video Swin-B block's parts on one GPU: the port of
``scripts/bench_swin_micro.py``.

    python -m ocpg_tpu_torch.scripts.bench_swin_micro [--iters 50]

It isolates the costs that a Swin-B dispatch's profile spreads over the
backbone, at the JAX script's shapes (one 5 x 384 x 640 clip, bf16):

* LayerNorm (``nn.LayerNorm``, float32 statistics as the Swin module
  computes them, and a hand-written one) at stage 2, flattened, and at
  stage 0;
* window attention at the four Swin-B serving calls of a shifted block
  (``swin_call``: stage s has 4 x 2^s heads of 32 channels over n = 245
  tokens, with the SW-MSA mask): the kernel (K7, ``window_attention``),
  its plain version (``window_attention_reference``) and, as a comparison
  only, ``scaled_dot_product_attention`` with bias + mask as its
  ``attn_mask``;
* the relative-position bias gather in two layouts;
* the stage-2 window partition and reverse relayout;
* the stage-2 MLP with exact and tanh-approximated GELU.

Each part is timed with ``utils/profiling.cuda_times`` (device ms per
call, the calls queued behind a sleep kernel, and the host's enqueue ms
beside it).  The report goes to ``--out`` (default
``output/bench/SWIN_MICRO_GPU.json``).  It needs a GPU.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# Swin-B serving path (video_swin_b_p4w7, one 5 x 384 x 640 clip): the token
# grid and heads of each stage; the (8, 7, 7) window clamps to T = 5, n = 245
SWIN_T, SWIN_WINDOW, SWIN_HEAD_DIM = 5, (8, 7, 7), 32
SWIN_GRIDS = ((96, 160), (48, 80), (24, 40), (12, 20))
SWIN_HEADS = (4, 8, 16, 32)
# the JAX script's bias table: (2 x 8 - 1) x 13 x 13 rows of the (8, 7, 7) window
BIAS_TABLE_ROWS = 2535

Part = Tuple[str, Callable[[], Any]]


def swin_call(grid, heads, window=SWIN_WINDOW, frames=SWIN_T):
    """(bw, heads, n, SW-MSA mask) of the window attention of a shifted
    block at one stage of a clip of ``frames`` frames (one clip, so nW = bw)."""
    from ..models import backbone_video_swin as video_swin

    dims = (frames,) + tuple(grid)
    ws, ss = video_swin._get_window_size(dims, window, tuple(w // 2 for w in window))
    tp, hp, wp = (-(-d // w) * w for d, w in zip(dims, ws))
    mask = video_swin._sw_attn_mask(tp, hp, wp, ws, ss)
    return mask.shape[0], heads, ws[0] * ws[1] * ws[2], mask


def wattn_inputs(bw, heads, n, dtype, seed, device="cuda"):
    """q (pre-scaled, contiguous), k and v (slices of one qkv tensor, as the
    Swin module hands them over) and a bias table gather's stand-in, all in
    dtype."""
    g = torch.Generator(device=device).manual_seed(seed)
    dh = SWIN_HEAD_DIM
    qkv = torch.randn(bw, n, 3, heads, dh, generator=g, device=device).to(dtype)
    bias = (torch.randn(heads, n, n, generator=g, device=device) * 0.5).to(dtype)
    return qkv[:, :, 0] * dh ** -0.5, qkv[:, :, 1], qkv[:, :, 2], bias


def serving_calls():
    """The four Swin-B serving calls: (stage, bw, heads, n, mask)."""
    return [(s,) + swin_call(SWIN_GRIDS[s], SWIN_HEADS[s]) for s in range(4)]


def attention_parts(device, calls=None, dtype=torch.bfloat16) -> List[Part]:
    """K7, the plain version and SDPA at each call (default: the serving
    calls), on the same inputs; the mask in q's type, as the Swin module
    hands it over; SDPA's mask (bias + mask) built outside the timed call."""
    from ..ops import window_attention as wattn

    parts = []
    for stage, bw, heads, n, mask_np in calls or serving_calls():
        q, k, v, bias = wattn_inputs(bw, heads, n, dtype, seed=11, device=device)
        mask = torch.from_numpy(mask_np).to(device, dtype)
        qt, kt, vt = (t.permute(0, 2, 1, 3) for t in (q, k, v))
        attn_mask = (bias[None] + mask[:, None]).contiguous()
        tag = f"stage{stage} window attn (bw={bw}, h={heads}, n={n}, masked)"
        parts += [
            (f"{tag} K7 kernel",
             lambda q=q, k=k, v=v, b=bias, m=mask: wattn.window_attention(q, k, v, b, m)),
            (f"{tag} plain",
             lambda q=q, k=k, v=v, b=bias, m=mask: wattn.window_attention_reference(
                 q, k, v, b, m)),
            (f"{tag} sdpa (comparison)",
             lambda q=qt, k=kt, v=vt, am=attn_mask: F.scaled_dot_product_attention(
                 q, k, v, attn_mask=am, scale=1.0).permute(0, 2, 1, 3)),
        ]
    return parts


def _layer_norm(x):
    """LayerNorm without an affine, float32 statistics, in x's type."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + 1e-5)).to(x.dtype)


def layernorm_parts(device, rng) -> List[Part]:
    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            device, torch.bfloat16)

    x5d = randn(1, 5, 24, 40, 512)
    big = randn(1, 5, 96, 160, 128)
    ln512 = torch.nn.LayerNorm(512, device=device)
    ln128 = torch.nn.LayerNorm(128, device=device)
    return [
        ("LayerNorm (1,5,24,40,512) bf16",
         lambda: F.layer_norm(x5d.float(), (512,), ln512.weight, ln512.bias).to(x5d.dtype)),
        ("LayerNorm (4800,512) bf16",
         lambda: F.layer_norm(x5d.reshape(-1, 512).float(), (512,), ln512.weight,
                              ln512.bias).to(x5d.dtype)),
        ("manual LN (1,5,24,40,512)", lambda: _layer_norm(x5d)),
        ("LayerNorm (1,5,96,160,128) bf16",
         lambda: F.layer_norm(big.float(), (128,), ln128.weight, ln128.bias).to(big.dtype)),
    ]


def bias_parts(device, rng, heads: int = 16, n: int = 245) -> List[Part]:
    """The relative-position bias gather: rows then a transpose to (h, n, n),
    or the transposed table indexed directly."""
    table = torch.from_numpy(rng.standard_normal((BIAS_TABLE_ROWS, heads)).astype(
        np.float32)).to(device, torch.bfloat16)
    idx = torch.from_numpy(rng.integers(0, BIAS_TABLE_ROWS, (n, n))).to(device)
    return [
        ("bias gather (n,n,h)->transpose",
         lambda: table[idx.reshape(-1)].reshape(n, n, heads).permute(2, 0, 1).contiguous()),
        ("bias gather direct (h,n,n)", lambda: table.t()[:, idx]),
    ]


def partition_reverse(x):
    """The stage-2 window partition (5, 7, 7) and its reverse around a scale."""
    b = x.shape[0]
    xw = x.reshape(b, 1, 5, 4, 7, 6, 7, 512).permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(
        -1, 245, 512)
    y = (xw * 1.0001).reshape(b, 1, 4, 6, 5, 7, 7, 512)
    return y.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, 5, 28, 42, 512)


def layout_parts(device, rng) -> List[Part]:
    xs = torch.from_numpy(rng.standard_normal((1, 5, 28, 42, 512)).astype(np.float32)).to(
        device, torch.bfloat16)
    return [("stage2 partition+reverse relayout", lambda: partition_reverse(xs))]


def mlp_parts(device, rng) -> List[Part]:
    def w(*shape):
        return torch.from_numpy((rng.standard_normal(shape) * 0.02).astype(np.float32)).to(
            device, torch.bfloat16)

    w1, w2 = w(512, 2048), w(2048, 512)
    xs = torch.from_numpy(rng.standard_normal((1, 5, 24, 40, 512)).astype(np.float32)).to(
        device, torch.bfloat16)
    return [
        ("stage2 MLP gelu exact", lambda: xs + F.gelu(xs @ w1) @ w2),
        ("stage2 MLP gelu tanh-approx", lambda: xs + F.gelu(xs @ w1, approximate="tanh") @ w2),
    ]


def parts(device) -> List[Part]:
    rng = np.random.default_rng(0)
    return (layernorm_parts(device, rng) + attention_parts(device) + bias_parts(device, rng)
            + layout_parts(device, rng) + mlp_parts(device, rng))


def get_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser("ocpg_tpu_torch.scripts.bench_swin_micro",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--out", default="output/bench/SWIN_MICRO_GPU.json")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    from ..models.build import resolve_device
    from ..utils.hw import nvidia_smi_line
    from ..utils.profiling import cuda_times

    args = get_args(argv)
    device = resolve_device("cuda")
    rows = {}
    with torch.no_grad():
        for name, fn in parts(device):
            ms, host_ms = cuda_times(fn, args.iters)
            rows[name] = {"ms": ms, "host_ms": host_ms}
            print(f"{name:<72s} {ms:8.4f} ms (host {host_ms:.4f} ms)", flush=True)
    record = {"iters": args.iters, "nvidia_smi": nvidia_smi_line(), "parts": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
        print(f"wrote {args.out}")
    return record


if __name__ == "__main__":
    main()
