"""Ref-YouTube-VOS inference to per-expression binary PNG masks:
counterpart of ``ocpg_tpu/cli/infer_ytvos.py``, one process per GPU.

Each (expression, chunk of ``--clip_len`` frames) is one request to
``engine/infer.ClipInferenceEngine``; the masks are resized to the
original size on the engine's device, thresholded and saved as
``<output_dir>/Annotations/<video>/<exp_id>/<frame>.png`` (0 or 255), the
layout the Ref-YTVOS server scores.  ``--clip_len 0`` runs whole videos
(one request per expression, clip_len = the split's longest video), the
reference's semantics.  ``--query_select global`` (the default) keeps
chunked runs equal to it: the frame-weighted mean of the chunks' query
scores (the whole-video mean) picks one query per expression, and the
chunks whose own best query differed run again with that query forced.

Usage:
    python -m ocpg_tpu_torch.cli.infer_ytvos --ytvos_path /data/ref-ytvos \\
        --checkpoint output/ytvos_r101/checkpoints

``--device cpu`` runs on the CPU (the tests do); without a GPU the default
device raises.  Over several GPUs the engine runs over the mesh and rank 0
alone writes, as ``cli/infer_davis.py``; every rank makes the same global
query selection from the gathered scores, so the re-runs stay in lockstep.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from .infer_davis import (add_engine_args, init_engine, load_frames, make_config,
                          resized_scores)


def get_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        "ocpg_tpu_torch.cli.infer_ytvos",
        description="Ref-YouTube-VOS inference on one GPU (the PyTorch port of "
                    "ocpg_tpu.cli.infer_ytvos).")
    p.add_argument("--ytvos_path", required=True)
    p.add_argument("--output_dir", default="output/ytvos")
    p.add_argument("--clip_len", type=int, default=36,
                   help="frames per chunk; 0 = whole-video forwards (clip_len = the "
                        "split's longest video)")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--query_select", default="global", choices=["global", "chunk"],
                   help="'global' (default): one query per expression from the "
                        "frame-weighted mean of its chunks' scores, the chunks whose "
                        "own argmax differed run again with it; 'chunk': each chunk's "
                        "own best query")
    add_engine_args(p)
    return p.parse_args(argv)


def select_global_queries(engine, requests, meta):
    """``--query_select global``: per expression, the query with the best
    frame-weighted mean score over its chunks; returns the indices of the
    requests whose own argmax differs, each replaced in ``requests`` by the
    same request with that query forced."""
    from ..engine.infer import InferRequest

    scores = engine.last_query_scores
    by_exp: Dict[str, list] = {}
    for k, (exp_id, _) in enumerate(meta):
        by_exp.setdefault(exp_id, []).append(k)
    redo = []
    for ks in by_exp.values():
        if len(ks) <= 1:
            continue
        tot = sum(requests[k].frames.shape[0] for k in ks)
        agg = sum(scores[k] * requests[k].frames.shape[0] for k in ks) / tot
        gq = int(agg.max(axis=-1).argmax())
        for k in ks:
            if int(scores[k].max(axis=-1).argmax()) != gq:
                r = requests[k]
                requests[k] = InferRequest(r.frames, r.text_ids, r.text_mask,
                                           query_override=gq)
                redo.append(k)
    return redo


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, int]:
    """Returns the counts of the run: requests, and chunks run again by
    ``--query_select global``."""
    args = get_args(argv)
    from PIL import Image

    from ..data.imageio import read_rgb
    from ..engine.infer import InferRequest
    from ..models.text_encoder import SimpleTokenizer

    cfg = make_config(args, "ytvos")
    tokenizer = SimpleTokenizer(args.tokenizer_path, vocab_size=cfg.text_vocab)
    root = Path(args.ytvos_path)
    with open(root / "meta_expressions" / args.split / "meta_expressions.json") as f:
        data = json.load(f)["videos"]
    img_folder = root / args.split / "JPEGImages"
    save_prefix = Path(args.output_dir) / "Annotations"

    if args.clip_len <= 0:
        # one static T covering the longest video; shorter videos ride as
        # padding frames, which the model's valid-frame mean skips
        args.clip_len = max(len(v["frames"]) for v in data.values())
        print(f"whole-video mode: clip_len={args.clip_len}", flush=True)
    clip_len = args.clip_len

    _, engine = init_engine(cfg, args, want_query_scores=args.query_select == "global")
    counts = {"requests": 0, "rerun": 0}
    for video, vdata in data.items():
        frames = vdata["frames"]
        chunks = [frames[s:s + clip_len] for s in range(0, len(frames), clip_len)]
        clip_cache = {}
        origin_size = None
        for ci, clip_names in enumerate(chunks):
            clip_cache[ci], origin_size = load_frames(
                img_folder, video, clip_names, args.resize, args.max_size)

        requests, meta = [], []
        texts = {exp_id: tokenizer([" ".join(ed["exp"].lower().split())])
                 for exp_id, ed in vdata["expressions"].items()}
        # chunk by chunk, so the engine runs each chunk's backbone once
        for ci in range(len(chunks)):
            for exp_id, (ids, attn) in texts.items():
                requests.append(InferRequest(clip_cache[ci], ids[0], attn[0]))
                meta.append((exp_id, ci))
        results = engine.run(requests)
        all_refs = list(engine.last_ref_points)
        counts["requests"] += len(requests)

        if args.query_select == "global":
            redo = select_global_queries(engine, requests, meta)
            if redo:
                redo_results = engine.run([requests[k] for k in redo])
                for i, k in enumerate(redo):
                    results[k] = redo_results[i]
                    all_refs[k] = engine.last_ref_points[i]
            counts["rerun"] += len(redo)
        if engine.mesh.rank != 0:           # rank 0 writes
            continue

        per, per_refs = {}, {}
        for k, ((exp_id, ci), m) in enumerate(zip(meta, results)):
            per.setdefault(exp_id, {})[ci] = (resized_scores(engine, m, origin_size)
                                              > args.threshold)
            if args.visualize:
                per_refs.setdefault(exp_id, {})[ci] = all_refs[k]

        for exp_id, by_chunk in per.items():
            video_masks = np.concatenate(
                [by_chunk[ci] for ci in range(len(chunks))], 0).astype(np.uint8) * 255
            out_dir = save_prefix / video / exp_id
            out_dir.mkdir(parents=True, exist_ok=True)
            for name, frame_mask in zip(frames, video_masks):
                Image.fromarray(frame_mask).save(out_dir / f"{name}.png")

        if args.visualize:
            from ..utils.visualize import COLORS, save_overlay

            origin_frames = {name: read_rgb(img_folder / video / f"{name}.jpg")
                             for name in frames}
            for ei, (exp_id, by_chunk) in enumerate(per.items()):
                masks = np.concatenate([by_chunk[ci] for ci in range(len(chunks))], 0)
                refs = np.concatenate([per_refs[exp_id][ci] for ci in range(len(chunks))], 0)
                vis_dir = Path(args.output_dir) / f"{args.split}_images" / video / exp_id
                vis_dir.mkdir(parents=True, exist_ok=True)
                for fi, name in enumerate(frames):
                    save_overlay(vis_dir / f"{name}.png", origin_frames[name], masks[fi],
                                 COLORS[ei % len(COLORS)], tuple(refs[fi]))
        print(f"done {video} ({len(requests)} clips, {engine.canvas_count} canvases)",
              flush=True)
    return counts


if __name__ == "__main__":
    main()
