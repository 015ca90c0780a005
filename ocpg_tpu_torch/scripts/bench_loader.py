"""Host input-pipeline throughput: can ClipLoader feed the GPU's train
step?  The port of ``scripts/bench_loader.py``.

It writes a seeded tree on disk at real frame sizes (JPEG 720 x 1280; the
JAX script's JPEG, PNG and JSON files byte for byte, its h5 files as h5py
reads them) and measures ``ClipLoader`` batches/s at the train shapes
(T=3, canvas 512 x 640, compact wire off, as the JAX script) over worker
counts.  ``--dataset ytvos`` (the default) is the JAX script's
Ref-YouTube-VOS tree with h5 heatmaps (written by ``data/h5.py``, no
h5py); ``--dataset davis`` writes the same frames and masks as a
Ref-DAVIS tree without them.

    python -m ocpg_tpu_torch.scripts.bench_loader [--dataset davis] [--workers 1 4 8]
        [--step_ms 540] [--out output/bench/LOADER_GPU.json]

``--step_ms`` (a train step's measured ms, for example ``bench.py``'s
``train_step_ms``) adds the steps/s the loader must sustain and whether its
best rate does.  Reference equivalent: the torch DataLoader with
num_workers=4 (the reference's main.py).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np

DATASETS = ("ytvos", "davis")


def build_tree(root: str, videos: int, frames_per_video: int, h: int = 720, w: int = 1280,
               dataset: str = "ytvos") -> None:
    """The JAX script's train tree: per video one noise frame saved as
    JPEGs, the object (index 1) a box over the centre half as palette PNGs
    (PIL), one expression; ``ytvos`` adds the AnnotationsWeakly h5
    heatmaps (0.9 in the box), ``davis`` leaves them out."""
    from PIL import Image

    from ..data.h5 import write_datasets

    if dataset not in DATASETS:
        raise ValueError(f"dataset {dataset!r} not in {DATASETS}")
    rng = np.random.default_rng(0)
    meta = {"videos": {}}
    for v in range(videos):
        video = f"vid{v}"
        os.makedirs(f"{root}/train/JPEGImages/{video}")
        os.makedirs(f"{root}/train/Annotations/{video}")
        if dataset == "ytvos":
            os.makedirs(f"{root}/train/AnnotationsWeakly/{video}")
        frames = [f"{i:05d}" for i in range(frames_per_video)]
        base = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        pal = np.zeros((h, w), np.uint8)
        pal[h // 4: 3 * h // 4, w // 4: 3 * w // 4] = 1
        heat = np.zeros((1, h, w), np.float32)
        heat[0, h // 4: 3 * h // 4, w // 4: 3 * w // 4] = 0.9
        for name in frames:
            Image.fromarray(base).save(
                f"{root}/train/JPEGImages/{video}/{name}.jpg", quality=85)
            Image.fromarray(pal, mode="P").save(
                f"{root}/train/Annotations/{video}/{name}.png")
            if dataset == "ytvos":
                write_datasets(f"{root}/train/AnnotationsWeakly/{video}/{name}.h5",
                               (("obj_ids", np.asarray([1])), ("heatPoint", heat),
                                ("heatBBox", heat)))
        meta["videos"][video] = {
            "frames": frames,
            "expressions": {"0": {"exp": "the big square", "obj_id": "1"}},
        }
    os.makedirs(f"{root}/meta_expressions/train")
    with open(f"{root}/meta_expressions/train/meta_expressions.json", "w") as f:
        json.dump(meta, f)


def batches_per_sec(loader, batches: int) -> float:
    """ClipLoader batches/s over ``batches`` batches after the first."""
    it = loader.epoch(0)
    next(it)                                   # warm: first batch
    t0 = time.time()
    count = 0
    for _ in it:
        count += 1
        if count >= batches:
            break
    return count / (time.time() - t0)


def get_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser("ocpg_tpu_torch.scripts.bench_loader",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--videos", type=int, default=4)
    ap.add_argument("--frames-per-video", type=int, default=24)
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--num-frames", type=int, default=3)
    ap.add_argument("--workers", type=int, nargs="+", default=[1, 4, 8])
    ap.add_argument("--dataset", default="ytvos", choices=DATASETS,
                    help="ytvos (h5 heatmaps) or davis (no h5)")
    ap.add_argument("--step_ms", type=float, default=None,
                    help="a train step's ms: the loader must sustain 1000 / step_ms batches/s")
    ap.add_argument("--out", default="output/bench/LOADER_GPU.json")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = get_args(argv)
    from ..data.datasets import build_dataset
    from ..data.loader import ClipLoader

    root = tempfile.mkdtemp(prefix="loaderbench_")
    try:
        t0 = time.time()
        build_tree(root, args.videos, args.frames_per_video, dataset=args.dataset)
        print(f"fixture tree ({args.dataset}) built in {time.time() - t0:.1f}s", flush=True)
        ds = build_dataset(args.dataset, root, "train", args.num_frames, "box")

        results = {}
        for nw in args.workers:
            loader = ClipLoader(ds, args.batch_size, canvas=(512, 640), train=True,
                                num_workers=nw, text_vocab=50265)
            bps = batches_per_sec(loader, args.batches)
            results[nw] = bps
            fps = bps * args.batch_size * args.num_frames
            print(f"workers={nw}: {bps:.2f} batches/s ({fps:.1f} train-frames/s, "
                  f"{1000 / bps:.0f} ms/batch)", flush=True)
        best = max(results.values())
        record = {"metric": "loader_batches_per_sec", "value": round(best, 2),
                  "dataset": args.dataset, "host_cores": os.cpu_count(),
                  "batches_per_sec_by_workers": {str(k): round(v, 3)
                                                 for k, v in results.items()}}
        if args.step_ms:
            budget = 1000.0 / args.step_ms
            record.update(gpu_steps_per_sec_budget=round(budget, 2),
                          feeds_one_gpu=best >= budget)
        print(json.dumps(record))
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(record, indent=1))
        return record
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
