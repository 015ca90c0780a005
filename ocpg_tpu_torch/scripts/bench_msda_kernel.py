"""MSDA kernel microbenchmark on the GPU.

    python -m ocpg_tpu_torch.scripts.bench_msda_kernel --variants cm r4 fk sep \\
        [--bwd] [--shapes eval|train|l0|l0train] [--n 5] [--check sep|cm|none]

The port of ``scripts/bench_msda_kernel.py``: the same arguments, the same
seeded inputs (numpy ``default_rng(0)``: a bf16 value, x, y and attention
weights in channel-major layout, a float32 cotangent), the same check and
the same paired timing, for the port's formulations of the channel-major
MSDA forward:

  cm   -- K1, ``ops/csrc/ms_deform_attn_fwd.cu`` (the model's kernel)
  r4   -- K5, dense sampling rows on the tensor cores (``ms_deform_attn_r4.cu``)
  fk   -- K6, separable hat rows with the levels fused on the contraction
          axis, on the tensor cores (``ms_deform_attn_fk.cu``)
  sep  -- the plain separable hat-matmul version (PyTorch ops)

``--bwd`` also times one gradient of <out, g> (forward and backward, as the
JAX bench's ``jax.grad``): K1 then K2 for ``cm``, autograd through the plain
separable version for ``sep``; r4 and fk are forward-only.  The JAX
script's other variants (``cm_ps``, ``cm_xk``, ``cm_rep``, ``cm_hc``,
``cm_rep_hc``) and ``--tile`` select Mosaic lowerings and tile sizes of the
TPU kernel, which have no Hopper counterpart; the script refuses them.

Before timing, every variant is held against the reference (``--check``)
at max |out - ref| / max |ref| < 2e-2.  A time is the median over 5 pairs of
(t_16 - t_2) / 14, t_k the CUDA-event time of k calls back to back, which
cancels the launch overhead.  It prints one line per time and, last, one
JSON object with every time, the check errors and the card's name and power
limit.  ``main(argv, device="cpu")`` runs the same code on the CPU through
the plain versions (the tests do, with a small level set added to
``SHAPE_SETS``); its times are the host clock's and name the device they
ran on.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ocpg_tpu_torch.ops import ms_deform_attn as msda
from ocpg_tpu_torch.ops import ms_deform_attn_variants as variants

SHAPE_SETS = {
    "eval": ((48, 80), (24, 40), (12, 20), (6, 10)),
    "train": ((64, 80), (32, 40), (16, 20), (8, 10)),
    "l0": ((48, 80),),
    "l0train": ((64, 80),),
}
VARIANTS = ("cm", "r4", "fk", "sep")
BWD_VARIANTS = ("cm", "sep")
TPU_ONLY = ("cm_ps", "cm_xk", "cm_rep", "cm_hc", "cm_rep_hc")
HEADS, HEAD_DIM, POINTS = 8, 32, 4


def parse_args(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=list(VARIANTS + TPU_ONLY))
    ap.add_argument("--shapes", default="eval", choices=list(SHAPE_SETS))
    ap.add_argument("--bwd", action="store_true",
                    help="also time one gradient (cm and sep only)")
    ap.add_argument("--n", type=int, default=5, help="frames (batch)")
    ap.add_argument("--tile", type=int, default=0,
                    help="the TPU kernel's query tile; refused when set")
    ap.add_argument("--check", default="sep", choices=["sep", "cm", "none"],
                    help="reference the variants are held against before timing")
    args = ap.parse_args(argv)
    tpu_only = [v for v in args.variants if v in TPU_ONLY]
    if tpu_only:
        ap.error(f"variants {tpu_only} select Mosaic lowerings of the TPU kernel "
                 "(P-stacked dots, expansion-side contractions, lane repeats, corner "
                 "hat rows) that have no Hopper counterpart; the port has cm, r4, fk, sep")
    if args.tile:
        ap.error("--tile sets the TPU kernel's query tile; the Hopper kernels' tiles are "
                 "fixed (K1/K2 one warp per query, r4/fk 64 queries per block)")
    return args


def make_inputs(shapes, n: int, device) -> Dict[str, torch.Tensor]:
    """The JAX bench's inputs: value (N, S, M, D) bf16, x / y / aw
    (N, M, L, P, Lq) float32 with aw normalised over (L, P), cotangent g
    (N, Lq, M * D) float32; Lq = S."""
    m, d, p, l = HEADS, HEAD_DIM, POINTS, len(shapes)
    s = sum(h * w for h, w in shapes)
    lq = s
    rng = np.random.default_rng(0)
    value = torch.from_numpy(rng.standard_normal((n, s, m, d))).to(torch.bfloat16)
    x = torch.from_numpy(rng.random((n, m, l, p, lq))).float()
    y = torch.from_numpy(rng.random((n, m, l, p, lq))).float()
    aw = torch.from_numpy(rng.random((n, m, l, p, lq))).float()
    aw = aw / aw.sum(dim=(2, 3), keepdim=True)
    g = torch.from_numpy(rng.standard_normal((n, lq, m * d))).float()
    return {k: t.to(device) for k, t in
            dict(value=value, x=x, y=y, aw=aw, g=g).items()}


def forward_fn(variant: str, shapes):
    if variant == "cm":
        return lambda v, x, y, a: msda.ms_deform_attn_cm(v, shapes, x, y, a)
    if variant == "r4":
        return lambda v, x, y, a: variants.ms_deform_attn_cm_r4(v, shapes, x, y, a)
    if variant == "fk":
        return lambda v, x, y, a: variants.ms_deform_attn_cm_fk(v, shapes, x, y, a)
    return lambda v, x, y, a: msda.ms_deform_attn_separable(
        v, shapes, *msda._cm_to_standard(x, y, a))


def gradient_fn(variant: str, shapes, g: torch.Tensor):
    fwd = forward_fn(variant, shapes)

    def grads(v, x, y, a):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (v, x, y, a)]
            out = fwd(*inputs)
            return torch.autograd.grad((out.float() * g).sum(), inputs)

    return grads


def _elapsed_ms(fn, iters: int, device) -> float:
    """Time of iters calls back to back: CUDA events on the card, the host
    clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3


def paired_ms(fn, device, n_long: int = 16, n_short: int = 2, pairs: int = 5) -> float:
    """Median over pairs of (t_long - t_short) / (n_long - n_short)."""
    _elapsed_ms(fn, n_short, device)        # warm-up: kernel load, allocator
    _elapsed_ms(fn, n_long, device)
    diffs = [(_elapsed_ms(fn, n_long, device) - _elapsed_ms(fn, n_short, device))
             / (n_long - n_short) for _ in range(pairs)]
    return float(np.median(diffs))


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> dict:
    """Run the bench; returns what the JSON line prints."""
    args = parse_args(argv)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the MSDA kernel bench runs on a CUDA device; none is available")
    shapes = SHAPE_SETS[args.shapes]
    t = make_inputs(shapes, args.n, device)
    inputs = (t["value"], t["x"], t["y"], t["aw"])
    result = {"bench": "msda_kernel", "shapes": args.shapes, "levels": shapes, "n": args.n,
              "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                         else "cpu"),
              "clock": "cuda events" if device.type == "cuda" else "host",
              "nvidia_smi": nvidia_smi_line() if device.type == "cuda" else None,
              "check": {}, "ms": {}}

    with torch.no_grad():
        if args.check != "none":
            ref = forward_fn(args.check, shapes)(*inputs).float()
            scale = max(ref.abs().max().item(), 1e-6)
            for variant in args.variants:
                out = forward_fn(variant, shapes)(*inputs).float()
                err = (out - ref).abs().max().item() / scale
                print(f"{variant}: max rel err vs {args.check} = {err:.2e}", flush=True)
                if not err < 2e-2:
                    raise RuntimeError(f"{variant} diverges from {args.check}: {err}")
                result["check"][variant] = err
            del ref, out
        for variant in args.variants:
            fn = forward_fn(variant, shapes)
            label = f"fwd/{variant}/{args.shapes}"
            result["ms"][label] = paired_ms(lambda: fn(*inputs), device)
            print(f"{label}: {result['ms'][label]:.4f} ms/call", flush=True)
    if args.bwd:
        for variant in [v for v in args.variants if v in BWD_VARIANTS]:
            fn = gradient_fn(variant, shapes, t["g"])
            label = f"bwd/{variant}/{args.shapes}"
            result["ms"][label] = paired_ms(lambda: fn(*inputs), device)
            print(f"{label}: {result['ms'][label]:.4f} ms/call", flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
