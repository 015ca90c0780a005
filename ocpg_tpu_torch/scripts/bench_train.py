"""Train-step throughput on one GPU, loader-fed or on a resident batch,
with an optional profile: the port of ``scripts/bench_train.py``.

    python -m ocpg_tpu_torch.scripts.bench_train [--frames 3] [--height 512] [--width 640]
        [--backbone resnet101] [--batch 1] [--iters 16] [--iters_short 2] [--trace]

The step is ``bench.py``'s (``ytvos_r101_boxsup``, bf16, the backbone
given, forward with the matcher, losses, backward, clip, AdamW with
``lr_drop_steps=[10**9]``) on ``synthetic_batch(default_rng(0))`` resident
on the card.  Step time is the median over ``--repeats`` (3) paired runs of
``(t_iters - t_iters_short) / (iters - iters_short)``, each run ending in a
device synchronize; the MFUs and GFLOPs are ``bench.py``'s (dense:
``FlopCounterMode``; kernels: the MSDA and window-attention entries).
``--trace`` profiles one more step (``utils/profiling.profile_run``:
device ms by kernel class, the top kernels, the device-busy share).
``--json_out`` appends one JSON line with the point (the sweep reads it);
the record is also written to ``--out`` (default
``output/bench/TRAIN_STEP_GPU.json``).

``--e2e N``: N steps fed by the real ``ClipLoader`` (compact wire) through
``parallel/mesh.prefetch_to_mesh`` (pinned copies on a side stream, two
batches ahead) from a seeded on-disk tree (``bench_loader.build_tree``:
``--e2e_videos`` videos of ``--e2e_frames_per_video`` 720 x 1280 frames),
then up to 50 steps on one resident batch as the device-bound floor; writes
``output/bench/E2E_TRAIN_GPU.json`` (or ``--out``).  ``--dataset ytvos``
(the default, the JAX script's tree) has the h5 heatmaps; ``--dataset
davis`` writes a Ref-DAVIS tree without them.

``--overfit N``: N steps on the one fixed batch and the loss curve;
writes ``output/bench/TRAIN_GPU.json`` (or ``--out``).

``--device cpu`` runs on the CPU; the default device raises without a GPU.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np

from . import bench, bench_loader


def get_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser("ocpg_tpu_torch.scripts.bench_train",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--backbone", default="resnet101")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--iters_short", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--trace", action="store_true",
                    help="profile one step: device ms by kernel class and the top kernels")
    ap.add_argument("--e2e", type=int, default=0, metavar="N",
                    help="N loader-fed steps from a seeded on-disk tree, beside the "
                         "resident-batch step")
    ap.add_argument("--e2e_workers", type=int, default=4)
    ap.add_argument("--e2e_videos", type=int, default=4)
    ap.add_argument("--e2e_frames_per_video", type=int, default=24)
    ap.add_argument("--dataset", default="ytvos", choices=bench_loader.DATASETS,
                    help="the --e2e tree: ytvos (h5 heatmaps) or davis")
    ap.add_argument("--overfit", type=int, default=0, metavar="N",
                    help="N optimizer steps on the one fixed batch; the loss trajectory")
    ap.add_argument("--json_out", default=None,
                    help="append one JSON line with the measured point")
    ap.add_argument("--out", default=None,
                    help="the record's file (default output/bench/TRAIN_STEP_GPU.json, "
                         "E2E_TRAIN_GPU.json with --e2e, TRAIN_GPU.json with --overfit; "
                         "'' for none)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def train_config(args):
    from ..config import ytvos_r101_boxsup

    return ytvos_r101_boxsup().replace(compute_dtype="bfloat16", backbone=args.backbone,
                                       num_frames=args.frames)


def _shape(args, cfg) -> str:
    return f"{args.batch}x{args.frames}f {args.height}x{args.width} {cfg.compute_dtype}"


def run_timing(args, cfg, device) -> Dict[str, Any]:
    from ..utils.hw import nvidia_smi_line
    from ..utils.profiling import launch_counts, reset_launch_counts

    peak = bench.peak_flops(device)
    reset_launch_counts()
    r = bench.measure_train(args.backbone, args.batch, args.frames, args.height, args.width,
                            device=device, cfg=cfg,
                            iters=(args.iters, args.iters_short, args.repeats),
                            profile=args.trace)
    launches = launch_counts()
    print(f"train step: {r['step_ms']:.1f} ms/step = {r['fps']:.1f} train-frames/s "
          f"(MFU dense {r['mfu_dense']:.3f} / incl kernels {r['mfu_incl']:.3f}, "
          f"{r['gflop_dense']:.0f}+{r['gflop_kernels']:.0f} GFLOP/step, peak "
          f"{peak['assumed_peak_tflops_bf16']:.0f} TF {peak['gpu_kind']}; {cfg.backbone}, "
          f"{_shape(args, cfg)}), last loss {r['loss']:.3f}", flush=True)
    return {
        "backbone": cfg.backbone, "batch": args.batch,
        "frames": args.frames, "height": args.height, "width": args.width,
        "step_ms": round(r["step_ms"], 1),
        "train_frames_per_sec_per_chip": round(r["fps"], 2),
        "train_mfu_dense": round(r["mfu_dense"], 4),
        "train_mfu_incl_custom_calls": round(r["mfu_incl"], 4),
        "gflop_per_step_dense": round(r["gflop_dense"], 3),
        "gflop_per_step_kernels": round(r["gflop_kernels"], 3),
        "assumed_peak_tflops_bf16": peak["assumed_peak_tflops_bf16"],
        "gpu_kind": peak["gpu_kind"],
        "nvidia_smi": nvidia_smi_line() if device.type == "cuda" else None,
        "profile_device_ms_by_class": (r["profile"] or {}).get("classes") if args.trace else None,
        "steps": r["calls"],
        "launches": launches,
    }


def run_e2e(args, cfg, device) -> Dict[str, Any]:
    """Loader-fed train steps beside the resident-batch step."""
    from ..data.datasets import build_dataset
    from ..data.loader import ClipLoader
    from ..engine.train import _to_device
    from ..parallel.mesh import prefetch_to_mesh
    from ..utils.hw import nvidia_smi_line

    root = tempfile.mkdtemp(prefix="e2ebench_")
    try:
        t0 = time.time()
        bench_loader.build_tree(root, args.e2e_videos, args.e2e_frames_per_video,
                                dataset=args.dataset)
        print(f"fixture tree ({args.dataset}) built in {time.time() - t0:.1f}s", flush=True)
        dataset = build_dataset(args.dataset, root, "train", args.frames, "box")
        loader = ClipLoader(dataset, args.batch, canvas=(args.height, args.width),
                            train=True, num_workers=args.e2e_workers,
                            text_vocab=cfg.text_vocab, compact=True)
        host_raw = next(iter(loader.epoch(0)))
        step = bench.train_step(cfg, device)

        def epochs():
            for e in itertools.count():
                yield from loader.epoch(e)

        it = prefetch_to_mesh(epochs(), device)
        for _ in range(4):                   # warm-up: cuDNN plans, loader spin-up
            step(next(it)[1])
        bench.sync_device(device)

        # every step reads its losses back (the finite check), so the loop
        # waits for the device each step, as training does
        t0 = time.perf_counter()
        for _ in range(args.e2e):
            metrics = step(next(it)[1])
        bench.sync_device(device)
        e2e_ms = (time.perf_counter() - t0) / args.e2e * 1000

        resident = _to_device(host_raw, device)
        step(resident)
        bench.sync_device(device)
        n_res = min(args.e2e, 50)
        t0 = time.perf_counter()
        for _ in range(n_res):
            metrics = step(resident)
        bench.sync_device(device)
        resident_ms = (time.perf_counter() - t0) / n_res * 1000
        return {
            "backbone": cfg.backbone,
            "shape": _shape(args, cfg),
            "steps": args.e2e,
            "e2e_train_step_ms": round(e2e_ms, 1),
            "e2e_steps_per_sec": round(1000.0 / e2e_ms, 3),
            "resident_step_ms": round(resident_ms, 1),
            "feed_overhead_pct": round((e2e_ms / resident_ms - 1) * 100, 1),
            "loader_workers": args.e2e_workers,
            "host_cores": os.cpu_count(),
            "dataset": args.dataset,
            "last_loss": metrics["loss"],
            "prefetch": "pinned copies on a side stream, two batches ahead (prefetch_to_mesh)",
            "wire_format": "compact (uint8 frames + u8 masks + f16 heatmaps, "
                           "on-device normalize)",
            "nvidia_smi": nvidia_smi_line() if device.type == "cuda" else None,
        }
    finally:
        shutil.rmtree(root, ignore_errors=True)


def run_overfit(args, cfg, device) -> Dict[str, Any]:
    """``--overfit`` optimizer steps on the one fixed batch, the loss curve."""
    from ..engine.train import _to_device

    step = bench.train_step(cfg, device)
    batch = _to_device(bench.bench_batch(args.batch, args.frames, args.height, args.width,
                                         cfg.text_vocab), device)
    curve = []
    for i in range(args.overfit):
        curve.append(step(batch)["loss"])
        if (i + 1) % 25 == 0 or i + 1 == args.overfit:
            print(f"step {i + 1}: loss {curve[-1]:.3f}", flush=True)
    return {
        "backbone": cfg.backbone,
        "shape": _shape(args, cfg),
        "steps": len(curve),
        "loss_first": curve[0],
        "loss_min10": float(np.mean(sorted(curve)[:10])),
        "loss_last10": float(np.mean(curve[-10:])),
        "curve_every_10": curve[::10],
        "converged": bool(np.mean(curve[-10:]) < 0.5 * curve[0]),
    }


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    from ..models.build import resolve_device

    args = get_args(argv)
    device = resolve_device(args.device)
    cfg = train_config(args)
    if args.e2e:
        record, name = run_e2e(args, cfg, device), "E2E_TRAIN_GPU.json"
    elif args.overfit:
        record, name = run_overfit(args, cfg, device), "TRAIN_GPU.json"
    else:
        record, name = run_timing(args, cfg, device), "TRAIN_STEP_GPU.json"
    print(json.dumps(record), flush=True)
    if args.json_out:
        with open(args.json_out, "a") as f:
            f.write(json.dumps(record) + "\n")
    out = os.path.join("output", "bench", name) if args.out is None else args.out
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(record, indent=1))
        print(f"wrote {out}")
    return record


if __name__ == "__main__":
    main()
