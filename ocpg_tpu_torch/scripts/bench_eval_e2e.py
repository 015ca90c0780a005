"""End-to-end A2D evaluation on one GPU: ``evaluate_a2d`` fed by the real
loader from a seeded on-disk tree, in ms per clip, beside the
resident-batch forward.  The port of ``scripts/bench_eval_e2e.py``.

    python -m ocpg_tpu_torch.scripts.bench_eval_e2e [--dataset jhmdb] [--videos 12] [--frames 8]

``--dataset a2d`` (the default) writes the JAX script's A2D-Sentences tree
(mp4 clips at the native 320 x 568, written with cv2, byte for byte; h5
instance masks and heatmaps written by ``data/h5.py``, which h5py reads
as the JAX script's); ``--dataset jhmdb`` writes a JHMDB-Sentences tree
(PNG frames at 240 x 320 and a ``puppet_mask.mat`` per video; PIL and
scipy).

The production configuration (``a2d_r101_boxsup``, bf16, random weights
from its seed) runs ``engine/evaluate.evaluate_a2d`` over the tree's clips
(T=3 around the annotated frame, canvas 512 x 640, compact wire): a warm
pass of each configuration, then three timed passes: the host
postprocess over the float16 logit wire, the device postprocess, and the
device postprocess at batch 4.  The floor is the same eval forward on one
batch resident on the card, ``--resident_iters`` times, one synchronize at
the end.  The record goes to ``--out`` (default
``output/bench/E2E_EVAL_GPU.json``).

``--device cpu`` runs on the CPU; the default device raises without a GPU.
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

from .bench import sync_device

H, W = 320, 568          # A2D clips320H native resolution
JHMDB_H, JHMDB_W = 240, 320


def build_a2d_tree(root: str, n_videos: int, n_frames: int) -> None:
    """The JAX script's A2D-Sentences tree: per video an mp4 of noise
    frames, the middle frame's h5 (an instance box mask, its heatmaps),
    one sentence."""
    import cv2

    from ..data.h5 import write_datasets

    rng = np.random.default_rng(7)
    os.makedirs(os.path.join(root, "Release", "clips320H"))
    os.makedirs(os.path.join(root, "text_annotations"))
    ann_lines = ["video_id,instance_id,query"]
    set_lines = []
    for v in range(n_videos):
        vid = f"vid{v:03d}"
        inst_dir = os.path.join(root, "text_annotations",
                                "a2d_annotation_with_instances", vid)
        os.makedirs(inst_dir)
        writer = cv2.VideoWriter(
            os.path.join(root, "Release", "clips320H", f"{vid}.mp4"),
            cv2.VideoWriter_fourcc(*"mp4v"), 10, (W, H))
        for _ in range(n_frames):
            writer.write((rng.random((H, W, 3)) * 255).astype(np.uint8))
        writer.release()
        mask = np.zeros((H, W), np.uint8)
        y, x = rng.integers(40, 200), rng.integers(40, 400)
        mask[y:y + 80, x:x + 120] = 1
        heat = np.zeros((1, H, W), np.float32)
        heat[0, y - 8:y + 88, x - 8:x + 128] = 0.8
        mid = f"{n_frames // 2:05d}.h5"
        write_datasets(os.path.join(inst_dir, mid),
                       (("instance", np.asarray([2])), ("reMask", mask.T),
                        ("heatBBox", heat), ("heatPoint", heat)))
        ann_lines.append(f"{vid},2,the large moving object on the left")
        set_lines.append(f"{vid},x,x,x,x,x,x,x,1")
    with open(os.path.join(root, "text_annotations", "a2d_annotation.txt"), "w") as f:
        f.write("\n".join(ann_lines) + "\n")
    with open(os.path.join(root, "Release", "videoset.csv"), "w") as f:
        f.write("\n".join(set_lines) + "\n")


def build_jhmdb_tree(root: str, n_videos: int = 7, n_frames: int = 12) -> None:
    """A JHMDB-Sentences tree: PNG frames (PIL) of a moving ellipse and its
    ``puppet_mask.mat`` (scipy.io.savemat), one sentence per video."""
    import scipy.io
    from PIL import Image

    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:JHMDB_H, 0:JHMDB_W]
    lines = ["video_id,query"]
    for v in range(n_videos):
        vid = f"vid{v}"
        frames_dir = os.path.join(root, "Rename_Images", "catch", vid)
        masks_dir = os.path.join(root, "puppet_mask", "catch", vid)
        os.makedirs(frames_dir)
        os.makedirs(masks_dir)
        puppet = np.zeros((JHMDB_H, JHMDB_W, n_frames), np.uint8)
        for k in range(n_frames):
            obj = (((yy - 100 - 3 * k - 5 * v) / 60.0) ** 2
                   + ((xx - 90 - 8 * k - 10 * v) / 40.0) ** 2) <= 1.0
            img = 60 + 120 * rng.random((JHMDB_H, JHMDB_W, 3))
            img[obj] = 0.4 * img[obj] + [140, 90, 30]
            Image.fromarray(img.astype(np.uint8)).save(
                os.path.join(frames_dir, f"{k + 1:05d}.png"))
            puppet[..., k] = obj
        scipy.io.savemat(os.path.join(masks_dir, "puppet_mask.mat"), {"part_mask": puppet})
        lines.append(f"{vid},a person {('catching', 'throwing')[v % 2]} a ball")
    with open(os.path.join(root, "jhmdb_annotation.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def resident_forward(model, batch: Dict, device):
    """The eval forward of one loader batch uploaded once: a closure that
    runs it again on the resident tensors."""
    import torch

    from ..data.loader import normalize_frames
    from ..engine.evaluate import _valid_indices
    from ..engine.infer import upload

    smask = upload(batch["samples_mask"], device)
    args = [normalize_frames(upload(batch["samples"], device), smask), smask,
            upload(batch["text_ids"], device), upload(batch["text_mask"], device),
            upload(batch["targets"]["size"], device)]
    vi = upload(_valid_indices(batch), device)

    def forward():
        with torch.no_grad():
            return model(*args, valid_indices=vi)

    return forward


def get_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser("ocpg_tpu_torch.scripts.bench_eval_e2e",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="a2d", choices=("a2d", "jhmdb"),
                    help="a2d (the JAX tree: mp4 + h5) or jhmdb (PNG + .mat)")
    ap.add_argument("--videos", type=int, default=12)
    ap.add_argument("--frames", type=int, default=8,
                    help="frames per video (the eval loader samples T=3 around the "
                         "annotated frame, as the reference does)")
    ap.add_argument("--resident_iters", type=int, default=20)
    ap.add_argument("--out", default="output/bench/E2E_EVAL_GPU.json")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """The passes of the module docstring."""
    from ..config import a2d_r101_boxsup
    from ..data.datasets import build_dataset
    from ..data.loader import ClipLoader
    from ..engine.evaluate import evaluate_a2d
    from ..models.build import build_model, resolve_device
    from ..models.text_encoder import SimpleTokenizer
    from ..utils.hw import nvidia_smi_line

    args = get_args(argv)
    device = resolve_device(args.device)
    root = tempfile.mkdtemp(prefix="e2eeval_")
    try:
        t0 = time.time()
        if args.dataset == "a2d":
            build_a2d_tree(root, args.videos, args.frames)
        else:
            build_jhmdb_tree(root, args.videos, args.frames)
        print(f"fixture tree ({args.dataset}) built in {time.time() - t0:.1f}s", flush=True)

        cfg = a2d_r101_boxsup().replace(compute_dtype="bfloat16", dataset_file=args.dataset)
        model = build_model(cfg, device)
        dataset = build_dataset(args.dataset, root, "val", cfg.num_frames)

        def loader(batch):
            return ClipLoader(dataset, batch,
                              tokenizer=SimpleTokenizer(None, vocab_size=cfg.text_vocab),
                              train=False, compact=True)

        loader1 = loader(1)

        def timed(what, ld, **kw):
            t0 = time.time()
            metrics = evaluate_a2d(model, ld, device=device, **kw)
            secs = time.time() - t0
            print(f"{what}: {secs:.1f}s", flush=True)
            return metrics, secs

        # warm passes: cuDNN plans, the kernels' first load (discarded)
        timed("warm host pass", loader1, readback="f16", postprocess="host")
        timed("warm device pass", loader1, postprocess="device")
        n_clips = len(dataset)
        # A: host postprocess over the f16 full-canvas logit wire
        metrics_host, secs = timed("host f16 pass", loader1, readback="f16",
                                   postprocess="host")
        e2e_ms = secs / n_clips * 1000
        # B: the device postprocess (crop, resize to the original size,
        # threshold and bit-pack on the card)
        metrics, secs = timed("device pass", loader1, postprocess="device")
        e2e_dev_ms = secs / n_clips * 1000
        # C: the device postprocess at batch 4 (fewer dispatches per clip)
        loader4 = loader(4)
        timed("warm device pass, batch 4", loader4, postprocess="device")
        metrics_b4, secs = timed("device pass, batch 4", loader4, postprocess="device")
        e2e_dev_b4_ms = secs / n_clips * 1000

        forward = resident_forward(model, next(iter(loader1.epoch(0))), device)
        forward()
        sync_device(device)
        t0 = time.perf_counter()
        for _ in range(args.resident_iters):
            forward()
        sync_device(device)
        resident_ms = (time.perf_counter() - t0) / args.resident_iters * 1000

        record = {
            "backbone": cfg.backbone,
            "dataset": args.dataset,
            "clips": n_clips,
            "shape": f"T={cfg.num_frames} canvas 512x640 {cfg.compute_dtype} "
                     + (f"({H}x{W} native mp4)" if args.dataset == "a2d"
                        else f"({JHMDB_H}x{JHMDB_W} native PNG)"),
            "e2e_eval_ms_per_clip_host_f16": round(e2e_ms, 1),
            "e2e_eval_ms_per_clip_device_post": round(e2e_dev_ms, 1),
            "e2e_eval_ms_per_clip_device_post_b4": round(e2e_dev_b4_ms, 1),
            "resident_forward_ms_per_clip": round(resident_ms, 1),
            "feed_overhead_pct_host_f16": round((e2e_ms / resident_ms - 1) * 100, 1),
            "feed_overhead_pct_device_post": round((e2e_dev_ms / resident_ms - 1) * 100, 1),
            "feed_overhead_pct_device_post_b4": round(
                (e2e_dev_b4_ms / resident_ms - 1) * 100, 1),
            "metrics_b1_vs_b4_max_abs_delta": max(
                abs(metrics[k] - metrics_b4[k]) for k in metrics),
            "wire_format": "compact uint8 frames up; device post: packed binary masks at "
                           "native resolution down (8 px/byte) + f32 logits",
            "metrics_finite": bool(all(np.isfinite(v) for v in metrics.values())),
            "metrics_host_vs_device_max_abs_delta": max(
                abs(metrics[k] - metrics_host[k]) for k in metrics),
            "metrics": metrics,
            "nvidia_smi": nvidia_smi_line() if device.type == "cuda" else None,
        }
        print(json.dumps(record), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(record, indent=1))
            print(f"wrote {args.out}")
        return record
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
