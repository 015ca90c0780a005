"""Ref-DAVIS17 inference to per-annotator palette PNG masks: counterpart of
``ocpg_tpu/cli/infer_davis.py``, one process per GPU.

Every (annotator, object, chunk) clip of a video becomes one request to
``engine/infer.ClipInferenceEngine``, which batches requests ``slots`` at a
time on canvases picked per request (``--buckets exact``, the default: the
request's own /64-aligned canvas) or from a bucket list.

Per video, as the reference's inference_davis.py: the expressions are
interleaved over 4 annotators (expression ``obj_id * 4 + anno_id``); per
object the best-query eval branch gives per-frame mask logits, resized to
the original size on the engine's device and passed through a sigmoid;
per annotator the object maps merge by argmax over a 0.1 background with a
0.3 floor, saved as palette PNGs under the ground truth's frame names
(``<output_dir>/<split>/anno_<i>/<video>/<frame>.png``).

Usage:
    python -m ocpg_tpu_torch.cli.infer_davis --davis_path /data/ref-davis \\
        --backbone video_swin_b_p4w7 --checkpoint output/davis/checkpoints

``--device cpu`` runs on the CPU (the tests do); without a GPU the default
device raises.  Over several GPUs (the ``OCPG_*`` environment or torchrun,
as ``cli/train.py``) the engine runs over the mesh, ``--per_device_batch``
requests per rank per dispatch, and rank 0 alone writes.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..data.imageio import read_rgb


def merge_annotator_masks(anno: np.ndarray) -> np.ndarray:
    """Merge one annotator's per-object score maps into a label map.

    Scores below the 0.3 floor are zeroed, a constant 0.1 background plane
    is prepended, and each pixel takes the argmax: a pixel is background
    unless some object scores >= 0.3, and ties between objects go to the
    lowest object id (``np.argmax``'s first occurrence).  Labels are 0 =
    background, i + 1 = object i.

    anno: (num_obj, T, H, W) sigmoid scores in [0, 1].  Returns (T, H, W) u8.
    """
    anno = anno.copy()
    anno[anno < 0.3] = 0.0
    bg = np.full((1,) + anno.shape[1:], 0.1, anno.dtype)
    return np.argmax(np.concatenate([bg, anno], axis=0), axis=0).astype(np.uint8)


def add_engine_args(p: argparse.ArgumentParser) -> None:
    """The flags the DAVIS and YTVOS inference CLIs share."""
    p.add_argument("--checkpoint", default=None,
                   help="a port checkpoints/ directory or a reference .pth file")
    p.add_argument("--backbone", default="resnet101")
    p.add_argument("--split", default="valid")
    p.add_argument("--per_device_batch", type=int, default=1,
                   help="requests per rank per dispatch (a dispatch holds "
                        "per_device_batch x ranks requests)")
    p.add_argument("--resize", type=int, default=360)
    p.add_argument("--max_size", type=int, default=640)
    p.add_argument("--tokenizer_path", default=None,
                   help="a RoBERTa tokenizer directory; default: the hash tokenizer")
    p.add_argument("--buckets", default="exact",
                   help="'exact' (default): each request's /64-aligned canvas, the "
                        "least padding (past 4 distinct canvases new shapes take the "
                        "serving buckets); 'serving': the 360p canvas trio; or "
                        "'H1xW1,H2xW2,...' buckets, multiples of 64.  Canvas padding "
                        "perturbs the GroupNorm statistics and the LFM spectrum")
    p.add_argument("--visualize", action="store_true",
                   help="also save overlays (mask blends, reference-point crosses) "
                        "to <output_dir>/<split>_images")
    p.add_argument("--readback", default="f32", choices=["f16", "f32"],
                   help="mask-logit readback: f32 (default) or f16, half the bytes")
    p.add_argument("--config_overrides", default=None,
                   help="JSON dict of OCPGConfig field overrides (tests/tools)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cpu for the tests)")


def get_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        "ocpg_tpu_torch.cli.infer_davis",
        description="Ref-DAVIS17 inference on one GPU (the PyTorch port of "
                    "ocpg_tpu.cli.infer_davis).")
    p.add_argument("--davis_path", required=True)
    p.add_argument("--output_dir", default="output/davis")
    p.add_argument("--clip_len", type=int, default=36)
    add_engine_args(p)
    return p.parse_args(argv)


def make_config(args: argparse.Namespace, dataset_file: str):
    from ..config import OCPGConfig, apply_config_overrides

    return apply_config_overrides(
        OCPGConfig(backbone=args.backbone, dataset_file=dataset_file),
        args.config_overrides)


def parse_buckets(spec: str):
    """--buckets spec -> the engine's bucket tuple.

    'exact' -> () (each request's /64-aligned canvas); 'serving' or
    'default' -> the 360p bucket trio; otherwise an 'H1xW1,...' list whose
    values must be positive multiples of 64 (the feature levels downsample
    64 times).
    """
    from ..engine.infer import DEFAULT_BUCKETS

    if spec == "exact":
        return ()
    if spec in ("serving", "default"):
        return DEFAULT_BUCKETS
    buckets = []
    for item in spec.split(","):
        parts = item.split("x")
        if len(parts) != 2:
            raise SystemExit(
                f"--buckets: malformed bucket {item!r} (expected HxW, e.g. 384x640)")
        try:
            h, w = int(parts[0]), int(parts[1])
        except ValueError:
            raise SystemExit(f"--buckets: non-integer bucket {item!r}")
        if h <= 0 or w <= 0 or h % 64 or w % 64:
            raise SystemExit(
                f"--buckets: bucket {item!r} must be positive multiples of 64 "
                "(the feature levels downsample x64)")
        buckets.append((h, w))
    return tuple(buckets)


def load_frames(img_folder: Path, video: str, frame_names, resize, max_size):
    """Decode and resize to the inference scale: un-normalised uint8 RGB
    frames (t, h, w, 3), the engine's compact wire (it normalises on the
    device), and the original (h, w).  The resize is cv2's uint8
    INTER_LINEAR (``data/transforms.resize_linear_u8``)."""
    from ..data.transforms import _target_size, resize_linear_u8

    imgs = []
    origin_size = None
    for name in frame_names:
        img = read_rgb(img_folder / video / f"{name}.jpg")
        if origin_size is None:
            origin_size = img.shape[:2]
        imgs.append(resize_linear_u8(img, _target_size(img.shape[0], img.shape[1],
                                                        resize, max_size)))
    return np.stack(imgs), origin_size


def init_engine(cfg, args: argparse.Namespace, want_query_scores: bool = False):
    """The model (seeded init, or ``--checkpoint``'s weights) on
    ``--device`` behind a ClipInferenceEngine over the data mesh (one
    rank without the ``OCPG_*`` environment); returns (model, engine)."""
    import torch

    from ..engine.checkpoint import load_checkpoint
    from ..engine.infer import ClipInferenceEngine
    from ..models.build import build_model, resolve_device
    from ..parallel.distributed import initialize_distributed
    from ..parallel.mesh import create_mesh, replicate

    resolve_device(args.device)
    initialize_distributed(device=args.device)
    mesh = create_mesh(device=args.device)
    model = build_model(cfg, mesh.device)
    if args.checkpoint:
        load_checkpoint(model, args.checkpoint, cfg)
    replicate(mesh, model)
    out_dtype = torch.float16 if args.readback == "f16" else torch.float32
    return model, ClipInferenceEngine(
        model, clip_len=args.clip_len, buckets=parse_buckets(args.buckets),
        out_dtype=out_dtype, want_ref_points=args.visualize,
        want_query_scores=want_query_scores, mesh=mesh,
        per_device_batch=args.per_device_batch)


def resized_scores(engine, logits: np.ndarray, origin_size) -> np.ndarray:
    """(t, h, w) mask logits -> (t, H, W) sigmoid scores at the original
    size, resized on the engine's device."""
    import torch

    from ..ops.image import bilinear_resize

    m = torch.from_numpy(logits).to(engine.device)
    m = bilinear_resize(m[None], tuple(origin_size), align_corners=False)[0]
    return torch.sigmoid(m).cpu().numpy()


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = get_args(argv)
    from PIL import Image

    from ..engine.infer import InferRequest
    from ..models.text_encoder import SimpleTokenizer

    cfg = make_config(args, "davis")
    tokenizer = SimpleTokenizer(args.tokenizer_path, vocab_size=cfg.text_vocab)
    root = Path(args.davis_path)
    with open(root / "meta_expressions" / args.split / "meta_expressions.json") as f:
        data = json.load(f)["videos"]
    img_folder = root / args.split / "JPEGImages"
    save_prefix = Path(args.output_dir) / f"{args.split}"

    # the palette of the first annotation PNG found
    palette = None
    for png in sorted((root / args.split / "Annotations").rglob("*.png")):
        palette = Image.open(png).getpalette()
        break

    _, engine = init_engine(cfg, args)
    for video, vdata in data.items():
        frames = vdata["frames"]
        expressions = vdata["expressions"]
        exp_list = list(expressions.keys())
        num_obj = len(exp_list) // 4

        # every (annotator, object, chunk) request of this video
        requests, meta = [], []
        origin_size = None
        chunks = [frames[s:s + args.clip_len] for s in range(0, len(frames), args.clip_len)]
        clip_cache = {}
        for ci, clip_names in enumerate(chunks):
            clip_cache[ci], origin_size = load_frames(
                img_folder, video, clip_names, args.resize, args.max_size)
        texts = {}
        for anno_id in range(4):
            for obj_id in range(num_obj):
                exp = expressions[exp_list[obj_id * 4 + anno_id]]["exp"]
                texts[anno_id, obj_id] = tokenizer([" ".join(exp.lower().split())])
        # chunk by chunk, so the engine runs each chunk's backbone once
        for ci in range(len(chunks)):
            for (anno_id, obj_id), (ids, attn) in texts.items():
                requests.append(InferRequest(clip_cache[ci], ids[0], attn[0]))
                meta.append((anno_id, obj_id, ci))
        results = engine.run(requests)
        if engine.mesh.rank != 0:           # rank 0 writes
            continue

        # per annotator and object, the chunks' scores at the original size
        per, per_refs = {}, {}
        for k, ((anno_id, obj_id, ci), m) in enumerate(zip(meta, results)):
            per.setdefault((anno_id, obj_id), {})[ci] = resized_scores(engine, m, origin_size)
            if args.visualize:
                # normalised to the valid (unpadded) region: they map onto
                # the original frame as they are
                per_refs.setdefault((anno_id, obj_id), {})[ci] = engine.last_ref_points[k]

        origin_frames = None
        if args.visualize:
            origin_frames = [read_rgb(img_folder / video / f"{name}.jpg") for name in frames]

        for anno_id in range(4):
            anno_masks = [np.concatenate([per[(anno_id, o)][ci] for ci in range(len(chunks))], 0)
                          for o in range(num_obj)]
            merged = merge_annotator_masks(np.stack(anno_masks))
            out_dir = save_prefix / f"anno_{anno_id}" / video
            out_dir.mkdir(parents=True, exist_ok=True)
            for fi in range(merged.shape[0]):
                img = Image.fromarray(merged[fi])
                if palette is not None:
                    img.putpalette(palette)
                # the scorer looks results up by the ground truth's frame id
                img.save(out_dir / f"{frames[fi]}.png")

            if args.visualize:
                from PIL import ImageDraw

                from ..utils.visualize import COLORS, draw_reference_points, vis_add_mask

                vis_dir = (Path(args.output_dir) / f"{args.split}_images"
                           / f"anno_{anno_id}" / video)
                vis_dir.mkdir(parents=True, exist_ok=True)
                obj_refs = [np.concatenate([per_refs[(anno_id, o)][ci]
                                            for ci in range(len(chunks))], 0)
                            for o in range(num_obj)]
                for fi in range(merged.shape[0]):
                    blend = origin_frames[fi]
                    for o in range(num_obj):
                        blend = vis_add_mask(blend, merged[fi] == o + 1, COLORS[o % len(COLORS)])
                    img = Image.fromarray(blend)
                    draw = ImageDraw.Draw(img)
                    for o in range(num_obj):
                        draw_reference_points(draw, [tuple(obj_refs[o][fi])], img.size,
                                              COLORS[o % len(COLORS)])
                    img.save(vis_dir / f"{frames[fi]}.png")
        print(f"done {video} ({len(requests)} clips, {engine.canvas_count} canvases)",
              flush=True)


if __name__ == "__main__":
    main()
