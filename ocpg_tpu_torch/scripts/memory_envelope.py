"""Peak device memory of the production configurations on one GPU: the
port of ``scripts/hbm_envelope.py``.

One row per operating point (R101 and Video Swin-B; train at the train
canvas 512 x 640 with and without per-block recompute, eval at the
inference canvas 384 x 640), so the recipes' per-GPU batches and
whole-video Ref-YouTube-VOS inference have a measured headroom.  PyTorch
has no ahead-of-time memory analysis, so each row runs: a fresh model
(``ytvos_r101_boxsup`` for train, ``a2d_r101_boxsup`` for eval, bf16, the
row's backbone) and its synthetic batch are made, the peak statistics are
reset, then two train steps run (the second holds AdamW's moments, which
the first step creates) or one eval forward under ``no_grad``.  The row
records ``max_memory_allocated`` and ``max_memory_reserved`` in MiB, less
what the process held before the row (nothing when the script runs
alone), and ``hbm_frac``, the allocated peak over the card's memory
(``utils/hw.gpu_spec``).  A row that runs out of memory is recorded with
``status: "oom"`` and the message, the cache is emptied and the next row
runs.

Usage:
    python -m ocpg_tpu_torch.scripts.memory_envelope [--quick] [--out output/MEMORY_ENVELOPE_GPU.json]

``--quick`` keeps the first two train and the first two eval rows.  It
needs a GPU (a CPU has no peak statistics): without one it raises.
"""

from __future__ import annotations

import argparse
import gc
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

TRAIN_CANVAS = (512, 640)
EVAL_CANVAS = (384, 640)

# (backbone, batch, frames, recompute) at the train canvas
TRAIN_GRID = [
    ("resnet101", 1, 3, False),
    ("resnet101", 2, 3, False),
    ("resnet101", 4, 3, False),
    ("resnet101", 2, 5, False),
    ("video_swin_b_p4w7", 1, 3, True),
    ("video_swin_b_p4w7", 2, 3, True),
    ("video_swin_b_p4w7", 2, 3, False),
]
# (backbone, batch, frames) at the inference canvas
EVAL_GRID = [
    ("resnet101", 1, 5),
    ("resnet101", 1, 36),
    ("resnet101", 1, 72),          # whole-video Ref-YouTube-VOS headroom probe
    ("video_swin_b_p4w7", 1, 5),
    ("video_swin_b_p4w7", 1, 36),
]


def grids(quick: bool):
    """The (train, eval) grids; ``quick`` keeps the first two of each."""
    return (TRAIN_GRID[:2], EVAL_GRID[:2]) if quick else (TRAIN_GRID, EVAL_GRID)


def run_train(backbone: str, batch: int, frames: int, height: int, width: int,
              use_checkpoint: bool, device) -> None:
    """Two train steps of a fresh full-width model on a synthetic batch."""
    from ..config import ytvos_r101_boxsup
    from ..data.synthetic import synthetic_batch
    from ..engine.optim import build_optimizer
    from ..engine.train import TrainStep
    from ..models.build import build_model, build_weight_dict, criterion_config

    cfg = ytvos_r101_boxsup().replace(compute_dtype="bfloat16", backbone=backbone,
                                      num_frames=frames, use_checkpoint=use_checkpoint)
    model = build_model(cfg, device)
    optimizer = build_optimizer(model, cfg, [10 ** 9])
    step = TrainStep(model, criterion_config(cfg), build_weight_dict(cfg), optimizer)
    host = synthetic_batch(np.random.default_rng(0), batch=batch, frames=frames,
                           height=height, width=width, vocab_size=cfg.text_vocab)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    for _ in range(2):
        step(host)
    torch.cuda.synchronize(device)


def run_eval(backbone: str, batch: int, frames: int, height: int, width: int,
             device) -> None:
    """One eval forward (A2D branch, ``valid_indices``) of a fresh
    full-width model on a synthetic clip."""
    from ..config import a2d_r101_boxsup
    from ..data.synthetic import synthetic_batch
    from ..models.build import build_model

    cfg = a2d_r101_boxsup().replace(compute_dtype="bfloat16", backbone=backbone)
    model = build_model(cfg, device)
    host = synthetic_batch(np.random.default_rng(0), batch=batch, frames=frames,
                           height=height, width=width, vocab_size=cfg.text_vocab)
    args = [torch.from_numpy(np.asarray(host[k])).to(device)
            for k in ("samples", "samples_mask", "text_ids", "text_mask")]
    sizes = torch.from_numpy(host["targets"]["size"]).to(device)
    vi = torch.zeros((batch,), dtype=torch.int32, device=device)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    with torch.no_grad():
        model(*args, sizes, vi, train=False)["pred_masks"]
    torch.cuda.synchronize(device)


def measure(fn, key: Dict[str, Any], device, hbm_bytes: int) -> Dict[str, Any]:
    """``fn()`` as one row: its peak allocated and reserved MiB above what
    the process held before it (nothing, run alone) and ``hbm_frac``, or
    ``status: "oom"`` with the message."""
    row = dict(key)
    t0 = time.time()
    held = torch.cuda.memory_allocated(device), torch.cuda.memory_reserved(device)
    try:
        fn()
    except torch.cuda.OutOfMemoryError as e:
        row.update(status="oom", error=str(e)[:300])
    else:
        peak = torch.cuda.max_memory_allocated(device) - held[0]
        reserved = torch.cuda.max_memory_reserved(device) - held[1]
        row.update(status="ok", allocated_mib=round(peak / 2 ** 20, 1),
                   reserved_mib=round(reserved / 2 ** 20, 1),
                   hbm_frac=round(peak / hbm_bytes, 3))
    finally:
        gc.collect()
        torch.cuda.empty_cache()
    row["wall_s"] = round(time.time() - t0, 1)
    return row


def envelope(quick: bool = False) -> Dict[str, Any]:
    """Every row of the (quick) grid on the GPU; returns the record."""
    from ..models.build import resolve_device
    from ..utils.hw import device_record, gpu_spec

    device = resolve_device("cuda")
    spec = gpu_spec(device)
    train_grid, eval_grid = grids(quick)
    rows: List[Dict[str, Any]] = []
    canvas = "x".join(map(str, TRAIN_CANVAS))
    for backbone, bs, t, remat in train_grid:
        rows.append(measure(
            lambda: run_train(backbone, bs, t, *TRAIN_CANVAS, remat, device),
            {"mode": "train", "backbone": backbone, "batch": bs, "frames": t,
             "canvas": canvas, "remat": remat}, device, spec.hbm_bytes))
        print(json.dumps(rows[-1]), flush=True)
    canvas = "x".join(map(str, EVAL_CANVAS))
    for backbone, bs, t in eval_grid:
        rows.append(measure(
            lambda: run_eval(backbone, bs, t, *EVAL_CANVAS, device),
            {"mode": "eval", "backbone": backbone, "batch": bs, "frames": t,
             "canvas": canvas}, device, spec.hbm_bytes))
        print(json.dumps(rows[-1]), flush=True)
    return {
        **device_record(device),
        "hbm_bytes_per_gpu": spec.hbm_bytes,
        "hbm_assumed": spec.assumed,
        "method": "torch.cuda.max_memory_allocated / max_memory_reserved after "
                  "reset_peak_memory_stats over two train steps (the second with "
                  "AdamW's moments) or one no_grad eval forward of a fresh bf16 model",
        "rows": rows,
    }


def get_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser("ocpg_tpu_torch.scripts.memory_envelope",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="only the first two train and the first two eval rows")
    ap.add_argument("--out", default="output/MEMORY_ENVELOPE_GPU.json")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = get_args(argv)
    record = envelope(args.quick)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
        print(f"wrote {args.out}")
    return record


if __name__ == "__main__":
    main()
