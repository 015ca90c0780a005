"""Profile the forward that ``bench.py`` times, on one GPU, and print where
its device time goes.  The port of ``scripts/profile_bench.py``.

    python -m ocpg_tpu_torch.scripts.profile_bench [--frames 5] [--height 384] [--width 640]
        [--backbone resnet101] [--iters 4] [--out output/bench/PROFILE_GPU.md]

``bench.py``'s headline forward (``a2d_r101_boxsup``, bf16, the backbone
given, ``valid_indices``, ``synthetic_batch(default_rng(0))`` on the card)
runs ``--iters`` times under ``torch.profiler`` after a warm-up
(``utils/profiling.profile_run``).  The report: the wall time and the
device-busy share of it, device ms by kernel class (``KERNEL_CLASSES``:
the MSDA and window-attention kernels, convolutions, GEMMs, FFTs, norms,
copies...), the top kernels with their launch counts, and the port's
kernels' launches; written as markdown to ``--out`` ("-" prints only).
It needs a GPU (without device time there is nothing to report).
"""

from __future__ import annotations

import argparse
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import bench


def report(prof: Dict[str, Any], iters: int, frames: int, top: int = 40) -> List[str]:
    """The markdown lines of a ``profile_run`` result over ``iters``
    forwards of ``frames`` frames."""
    busy, wall = prof["busy_ms"], prof["wall_ms"]
    lines = [f"wall {wall:.2f} ms over {iters} forwards, device busy {busy:.2f} ms "
             f"({100 * busy / wall:.1f}%; {busy / iters:.2f} device ms per clip, "
             f"{frames * iters * 1e3 / busy:.1f} frames/s of device time, "
             f"{frames * iters * 1e3 / wall:.1f} frames/s of wall time)",
             "", "## By class", "", "| class | ms | % |", "|---|---|---|"]
    for cls, ms in sorted(prof["classes"].items(), key=lambda kv: -kv[1]):
        lines.append(f"| {cls} | {ms:.2f} | {100 * ms / busy:.1f}% |")
    lines += ["", f"## Top {top} kernels", "", "| kernel | ms | launches | % |",
              "|---|---|---|---|"]
    for name, (ms, n) in sorted(prof["kernels"].items(), key=lambda kv: -kv[1][0])[:top]:
        short = re.sub(r"\s+", " ", name)[:110]
        lines.append(f"| `{short}` | {ms:.2f} | {n} | {100 * ms / busy:.1f}% |")
    return lines


def get_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser("ocpg_tpu_torch.scripts.profile_bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--height", type=int, default=384)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--backbone", default="resnet101")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--out", default="output/bench/PROFILE_GPU.md")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    from ..config import a2d_r101_boxsup
    from ..models.build import build_model, resolve_device
    from ..utils.hw import nvidia_smi_line
    from ..utils.profiling import launch_counts, profile_run, reset_launch_counts

    args = get_args(argv)
    device = resolve_device("cuda")
    cfg = a2d_r101_boxsup().replace(compute_dtype="bfloat16", backbone=args.backbone)
    model = build_model(cfg, device)
    host = bench.bench_batch(1, args.frames, args.height, args.width, cfg.text_vocab)
    inputs = [torch.from_numpy(np.asarray(host[k])).to(device)
              for k in ("samples", "samples_mask", "text_ids", "text_mask")]
    inputs.append(torch.from_numpy(host["targets"]["size"]).to(device))
    vi = torch.zeros((1,), dtype=torch.int32, device=device)

    def forwards():
        for _ in range(args.iters):
            model(*inputs, vi)

    print("warm-up ...", flush=True)
    forwards()
    torch.cuda.synchronize(device)
    reset_launch_counts()
    prof = profile_run(f"{args.iters} forwards ({args.backbone}, {args.frames}f "
                       f"{args.height}x{args.width} bf16)", forwards)
    launches = launch_counts()
    if prof is None:
        raise RuntimeError("torch.profiler recorded no device time")
    smi = nvidia_smi_line()
    lines = report(prof, args.iters, args.frames)
    lines += ["", f"kernel launches: {launches}", "", f"card: {smi}"]
    text = "\n".join(lines)
    print(text, flush=True)
    if args.out and args.out != "-":
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(f"# Bench profile: {args.backbone} {args.frames}f "
                                  f"{args.height}x{args.width} bf16\n\n{text}\n")
        print(f"wrote {args.out}")
    return {"profile": {k: v for k, v in prof.items() if k != "kernels"},
            "launches": launches, "nvidia_smi": smi, "iters": args.iters}


if __name__ == "__main__":
    main()
