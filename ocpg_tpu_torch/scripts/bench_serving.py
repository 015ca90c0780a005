"""Serving-request time: ``ClipInferenceEngine.run`` ms per request on one
GPU, and the A/B of its two serving knobs.  The port of
``scripts/bench_serving.py``.

    python -m ocpg_tpu_torch.scripts.bench_serving [--reqs 8] [--frames 12] [--rounds 3]

The JAX script's workload: ``a2d_r101_boxsup`` (bf16, the backbone given,
random weights from the configuration's seed) behind the engine with
``clip_len`` = the request length, answering ``--reqs`` requests of
``--frames`` uint8 frames at 360 x 640 per ``run()`` (the same pool from
the same seed as the JAX script), warm, the median of ``--rounds`` rounds.
Four configurations: ``pipeline_depth`` 1 with float32 readback (a
synchronous engine) against 2 with float16 (two dispatches in flight, half
the readback bytes), and each knob alone.  It is
an end-to-end wall-clock measurement (host assembly, upload, compute,
readback), because that is what the pipelining overlaps.  The record goes
to ``--out`` (default ``output/bench/SERVING_GPU.json``).

``--device cpu`` runs on the CPU; the default device raises without a GPU.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

LT = 10


def request_pool(n: int, frames: int, height: int, width: int) -> List:
    """The JAX script's requests from ``default_rng(0)``: uint8 frames,
    token ids ``[0, 3 random ids, 1...]`` of length 10, all attended."""
    from ..engine.infer import InferRequest

    rng = np.random.default_rng(0)
    reqs = []
    for _ in range(n):
        ids = np.full((LT,), 1, np.int32)
        ids[0] = 0
        ids[1:4] = rng.integers(4, 1000, 3)
        reqs.append(InferRequest(
            rng.integers(0, 256, (frames, height, width, 3)).astype(np.uint8),
            ids, np.ones((LT,), np.int32)))
    return reqs


def get_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser("ocpg_tpu_torch.scripts.bench_serving",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--reqs", type=int, default=8)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--backbone", default="resnet101")
    ap.add_argument("--out", default="output/bench/SERVING_GPU.json")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """The A/B of the module docstring."""
    import torch

    from ..config import a2d_r101_boxsup
    from ..engine.infer import ClipInferenceEngine
    from ..models.build import build_model, resolve_device
    from ..utils.hw import nvidia_smi_line

    args = get_args(argv)
    device = resolve_device(args.device)
    cfg = a2d_r101_boxsup().replace(compute_dtype="bfloat16", backbone=args.backbone)
    model = build_model(cfg, device)
    reqs = request_pool(args.reqs, args.frames, args.height, args.width)

    def measure(tag, **engine_kw):
        engine = ClipInferenceEngine(model, clip_len=args.frames, device=device, **engine_kw)
        engine.run(reqs)                      # warm-up: cuDNN plans, first upload
        times = []
        for _ in range(args.rounds):
            t0 = time.perf_counter()
            engine.run(reqs)
            times.append((time.perf_counter() - t0) / len(reqs) * 1000)
        ms = sorted(times)[len(times) // 2]
        print(f"{tag}: {ms:.0f} ms/request (runs: {[round(x) for x in times]})", flush=True)
        return round(ms, 1)

    results = {
        "sync_f32_ms_per_request": measure(
            "sync+f32", pipeline_depth=1, out_dtype=torch.float32),
        "pipelined_f16_ms_per_request": measure(
            "pipelined+f16", pipeline_depth=2, out_dtype=torch.float16),
        # the two knobs alone
        "pipelined_f32_ms_per_request": measure(
            "pipelined+f32", pipeline_depth=2, out_dtype=torch.float32),
        "sync_f16_ms_per_request": measure(
            "sync+f16", pipeline_depth=1, out_dtype=torch.float16),
    }
    record = {
        "workload": f"{args.reqs} x {args.frames}-frame {args.height}x{args.width} uint8 "
                    f"requests per run(), {cfg.backbone}, warm, median of {args.rounds} rounds",
        "note": "end-to-end wall clock incl. host assembly, upload, compute and readback "
                "(what pipelining overlaps)",
        **results,
        "speedup_pipelined_f16_vs_sync_f32": round(
            results["sync_f32_ms_per_request"] / results["pipelined_f16_ms_per_request"], 3),
        "nvidia_smi": nvidia_smi_line() if device.type == "cuda" else None,
    }
    print(json.dumps(record), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
        print(f"wrote {args.out}")
    return record


if __name__ == "__main__":
    main()
