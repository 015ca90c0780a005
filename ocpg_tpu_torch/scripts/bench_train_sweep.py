"""Train operating points on one GPU: batch x frames per backbone, each
point in a fresh process.  The port of ``scripts/bench_train_sweep.py``.

    python -m ocpg_tpu_torch.scripts.bench_train_sweep [--backbones resnet101 video_swin_b_p4w7]
        [--batches 1 2 4] [--frames 3 5] [--out output/bench/TRAIN_OPPOINTS_GPU.json]

The reference recipe trains at batch 2 per GPU, T=3 (its
``dist_train_a2d_resnet101_boxsup.sh`` and ``opts.py``), and T=5 recipes
exist.  Each point runs ``python -m ocpg_tpu_torch.scripts.bench_train``
(step ms, frames/s, the dense and kernel-inclusive MFU) in a child process,
so the card's memory is clean; a child that runs out of memory
(``torch.OutOfMemoryError``) is that point's ``"oom"`` row, and the larger
batches at its T are skipped.  Unlike ``memory_envelope.py`` it records
time and MFU.  Points accumulate into ``--out`` across runs, keyed by
(backbone, batch, frames), and the file is rewritten after every point.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

CHILD = [sys.executable, "-m", "ocpg_tpu_torch.scripts.bench_train"]
OOM_MARKERS = ("OutOfMemoryError", "CUDA out of memory", "out of memory")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_point(backbone: str, batch: int, frames: int, height: int, width: int,
              timeout: float = 3600, child: Sequence[str] = CHILD,
              extra: Sequence[str] = ()) -> Dict[str, Any]:
    """One point: ``child`` (bench_train) with the point's flags and
    ``--json_out``; its JSON line, or the status it failed with."""
    fd, out = tempfile.mkstemp(suffix=".jsonl")
    os.close(fd)
    os.unlink(out)
    cmd = [*child, "--backbone", backbone, "--batch", str(batch), "--frames", str(frames),
           "--height", str(height), "--width", str(width), "--json_out", out,
           "--out", "", *extra]
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    rec = {"backbone": backbone, "batch": batch, "frames": frames,
           "height": height, "width": width}
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=env)
    except subprocess.TimeoutExpired:
        proc = None
    rec["wall_s"] = round(time.time() - t0, 1)
    if proc is None:
        rec["status"] = "timeout"
    elif proc.returncode == 0 and os.path.exists(out):
        with open(out) as f:
            rec.update(json.loads(f.readlines()[-1]))
        rec["status"] = "ok"
    else:
        tail = (proc.stderr or "")[-4000:]
        rec["status"] = ("oom" if any(m in tail for m in OOM_MARKERS)
                         else f"failed(rc={proc.returncode})")
        rec["stderr_tail"] = tail[-800:]
    if os.path.exists(out):
        os.unlink(out)
    return rec


def grid(backbones: Sequence[str], frames: Sequence[int],
         batches: Sequence[int]) -> Iterator[Tuple[str, int, int]]:
    """(backbone, frames, batch) in the JAX sweep's order."""
    for backbone in backbones:
        for t in frames:
            for b in batches:
                yield backbone, t, b


def sweep(args, run=run_point) -> Dict[str, Any]:
    """Every point of the grid (an OOM skips the larger batches at its T),
    merged into ``args.out`` after each point; returns the artifact."""
    points: List[Dict[str, Any]] = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            points = [p for p in json.load(f).get("points", [])
                      if not str(p.get("status", "")).startswith("failed")]

    def upsert(rec):
        key = (rec["backbone"], rec["batch"], rec["frames"])
        points[:] = [p for p in points if (p["backbone"], p["batch"], p["frames"]) != key]
        points.append(rec)

    artifact = {
        "canvas": f"{args.height}x{args.width} bf16",
        "method": "paired-median train step (ocpg_tpu_torch/scripts/bench_train.py), "
                  "one fresh process per point",
        "reference_operating_point": "bs=2/GPU T=3 (dist_train_a2d_resnet101_boxsup.sh, "
                                     "opts.py)",
        "points": points,
    }
    oom_at = None
    for backbone, frames, batch in grid(args.backbones, args.frames, args.batches):
        if oom_at == (backbone, frames):
            continue                 # larger batches at this T run out of memory too
        print(f"--- {backbone} bs={batch} T={frames} ---", flush=True)
        rec = run(backbone, batch, frames, args.height, args.width,
                  extra=("--iters", str(args.iters), "--iters_short", str(args.iters_short),
                         "--repeats", str(args.repeats)))
        print(json.dumps(rec), flush=True)
        upsert(rec)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(artifact, f, indent=1)
        if rec["status"] == "oom":
            oom_at = (backbone, frames)
    return artifact


def get_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser("ocpg_tpu_torch.scripts.bench_train_sweep",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--backbones", nargs="+", default=["resnet101", "video_swin_b_p4w7"])
    ap.add_argument("--batches", nargs="+", type=int, default=[1, 2, 4])
    ap.add_argument("--frames", nargs="+", type=int, default=[3, 5])
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--iters_short", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default="output/bench/TRAIN_OPPOINTS_GPU.json")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = get_args(argv)
    artifact = sweep(args)
    if args.out:
        print(f"wrote {args.out}")
    return artifact


if __name__ == "__main__":
    main()
