"""Offline pseudo-label generation for A2D and Ref-YouTube-VOS: counterpart
of ``ocpg_tpu/preprocess/generate_anno.py``.

Per annotated frame and instance: the object centre (the maximum of the
mask's distance transform), the ground-truth box, the sim model's point-
and bbox-mode soft masks resized to the frame (optionally refined by the
dense CRF); written as ``heatBBox``, ``heatPoint`` and ``centerPoint`` into
an h5 file, which the train readers read.  The files are written by
``data/h5.py`` (numpy and the standard library), where the JAX package
uses h5py: Ref-YTVOS gets a new file per frame, A2D's annotation file is
rewritten with the maps added (``update_datasets``).

The JAX package finds the centre with cv2
(``minMaxLoc(distanceTransform(mask, DIST_L2, 5))``); ``object_center``
gives the same point without cv2: the 5 x 5 chamfer distance of cv2 5.0
(weights 1, 1.4 and 2.1969, float32 sums in its two raster passes, pixels
outside the image never background) and the first maximum in raster
order.  The heat maps resize with ``data/transforms.resize_linear`` (cv2's
float ``INTER_LINEAR``).  The sim model's features are computed once per
frame and shared by its instances.

Usage:
    python -m ocpg_tpu_torch.preprocess.generate_anno --dataset a2d --root /data/a2d \\
        --densecl checkpoints/densecl_r101.pth [--crf]

``--device cpu`` runs on the CPU; without a GPU the default device raises.
cv2 decodes A2D's mp4 clips.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.h5 import read_datasets, update_datasets, write_datasets
from ..data.imageio import read_palette, read_rgb
from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD, resize_linear

# cv2's 5 x 5 L2 chamfer weights: a horizontal or vertical step, a
# diagonal one, a knight's move
_HV, _DIAG, _LONG = np.float32(1.0), np.float32(1.4), np.float32(2.1969)
_FAR = np.finfo(np.float32).max
# (row offset, column offset, weight) of the pixels the forward pass reads;
# the backward pass reads the mirrored ones
_FORWARD = ((-2, -1, _LONG), (-2, 1, _LONG), (-1, -2, _LONG), (-1, -1, _DIAG), (-1, 0, _HV),
            (-1, 1, _DIAG), (-1, 2, _LONG), (0, -1, _HV))


def _chamfer_pass(t: np.ndarray, src: np.ndarray, neighbours, backward: bool) -> None:
    """One raster pass of cv2's 5 x 5 distance transform over ``t``, the
    (H + 4, W + 4) float32 distances padded by 2 with ``_FAR``, in place.

    Pixel (i, j) of the forward pass reads pixels of rows i - 2 and i - 1
    up to column j + 2, and (i, j - 1): all earlier on the wavefront
    ``3 i + j``, so each wavefront is one vectorised step, and every sum is
    the same single float32 addition cv2 makes.  The backward pass runs
    the mirrored wavefronts and starts from the forward value.
    """
    h, w = src.shape
    flat, zero, stride = t.reshape(-1), src.reshape(-1) == 0, w + 4
    offsets = [(dr * stride + dc, wt) for dr, dc, wt in neighbours]
    for tau in range(3 * (h - 1) + w):
        i = np.arange(max(0, -(-(tau - w + 1) // 3)), min(h - 1, tau // 3) + 1)
        j = tau - 3 * i
        if backward:
            i, j = h - 1 - i, w - 1 - j
        at = (i + 2) * stride + j + 2
        cand = flat[at] if backward else np.full(len(i), _FAR, np.float32)
        for off, wt in offsets:
            cand = np.minimum(cand, flat[at + off] + wt)
        flat[at] = np.where(zero[i * w + j], np.float32(0), cand)


def chamfer_distance(mask: np.ndarray) -> np.ndarray:
    """``cv2.distanceTransform((mask > 0).astype(uint8), cv2.DIST_L2, 5)``:
    float32 (H, W) distances to the nearest zero pixel, ``FLT_MAX`` where
    there is none (outside the image is never a zero pixel)."""
    src = (np.asarray(mask) > 0).astype(np.uint8)
    h, w = src.shape
    t = np.full((h + 4, w + 4), _FAR, np.float32)
    _chamfer_pass(t, src, _FORWARD, backward=False)
    _chamfer_pass(t, src, tuple((-dr, -dc, wt) for dr, dc, wt in _FORWARD), backward=True)
    return t[2:h + 2, 2:w + 2].copy()


def object_center(mask: np.ndarray) -> Tuple[int, int]:
    """The interior point (x, y) of a mask: the first maximum, in raster
    order, of its chamfer distance (cv2's minMaxLoc)."""
    dist = chamfer_distance(mask)
    y, x = np.unravel_index(int(np.argmax(dist)), dist.shape)
    return int(x), int(y)


def generate_for_frame(model, image_rgb: np.ndarray, inst_masks: np.ndarray,
                       use_crf: bool = False):
    """image_rgb: (H, W, 3) uint8; inst_masks: (N, H, W) binary.

    Returns (heatBBox (N, H, W), heatPoint (N, H, W), centerPoint (N, 2)),
    the soft masks resized to the frame; an empty mask gives zero maps and
    centre (0, 0).  The sim model runs on its own device.
    """
    from .sim_model import bbox_heat, image_keys, point_heat

    h, w = image_rgb.shape[:2]
    x = (image_rgb.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    device = next(model.parameters()).device
    keys = None

    heat_bbox, heat_point, centers = [], [], []
    for m in inst_masks:
        if not (m > 0).any():
            heat_bbox.append(np.zeros((h, w), np.float32))
            heat_point.append(np.zeros((h, w), np.float32))
            centers.append((0, 0))
            continue
        if keys is None:
            keys = image_keys(model, torch.from_numpy(x.transpose(2, 0, 1)[None]).to(device))
        cx, cy = object_center(m)
        ys, xs = np.where(m > 0)
        box = (float(xs.min()), float(ys.min()), float(xs.max()), float(ys.max()))
        hp = resize_linear(point_heat(keys, (cx / w, cy / h))[None], (h, w))[0]
        hb = resize_linear(bbox_heat(keys, box, (h, w))[None], (h, w))[0]
        if use_crf:
            from .dense_crf import apply_dense_crf

            hp = apply_dense_crf(image_rgb, hp)
            hb = apply_dense_crf(image_rgb, hb)
        heat_point.append(hp.astype(np.float32))
        heat_bbox.append(hb.astype(np.float32))
        centers.append((cx, cy))
    return np.stack(heat_bbox), np.stack(heat_point), np.asarray(centers, np.float32)


def run_a2d(root: str, model, use_crf: bool) -> None:
    """Every annotated frame of A2D-Sentences: the maps go into the
    frame's own annotation h5 (``reMask`` stored transposed), rewritten
    with every other dataset kept bit for bit and its attributes (MATLAB's
    ``MATLAB_class``, which no reader uses) dropped."""
    import cv2

    root_p = Path(root)
    mask_dir = root_p / "text_annotations" / "a2d_annotation_with_instances"
    videos_dir = root_p / "Release" / "clips320H"
    for vdir in sorted(mask_dir.iterdir()):
        if not vdir.is_dir():
            continue
        cap = cv2.VideoCapture(str(videos_dir / f"{vdir.name}.mp4"))
        frames = []
        while True:
            ok, fr = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(fr, cv2.COLOR_BGR2RGB))
        cap.release()
        for hf in sorted(vdir.glob("*.h5")):
            masks = read_datasets(hf, ("reMask",))["reMask"]
            if masks.ndim == 2:
                masks = masks[None]
            masks = np.transpose(masks, (0, 2, 1))
            hb, hp, cp = generate_for_frame(model, frames[int(hf.stem) - 1], masks, use_crf)
            update_datasets(hf, (("heatBBox", hb), ("heatPoint", hp), ("centerPoint", cp)),
                            drop_attributes=True)
        print(f"done {vdir.name}", flush=True)


def run_ytvos(root: str, model, use_crf: bool, split: str = "train") -> None:
    """Every annotated frame of Ref-YTVOS: one h5 per frame under
    ``<split>/AnnotationsWeakly/<video>/``, with the frame's object ids."""
    root_p = Path(root) / split
    ann_dir = root_p / "Annotations"
    img_dir = root_p / "JPEGImages"
    out_dir = root_p / "AnnotationsWeakly"
    for vdir in sorted(ann_dir.iterdir()):
        if not vdir.is_dir():
            continue
        (out_dir / vdir.name).mkdir(parents=True, exist_ok=True)
        for png in sorted(vdir.glob("*.png")):
            pal = read_palette(png)
            obj_ids = [int(o) for o in np.unique(pal) if o != 0]
            if not obj_ids:
                continue
            img = read_rgb(img_dir / vdir.name / f"{png.stem}.jpg")
            masks = np.stack([(pal == o).astype(np.float32) for o in obj_ids])
            hb, hp, cp = generate_for_frame(model, img, masks, use_crf)
            write_datasets(out_dir / vdir.name / f"{png.stem}.h5",
                           (("obj_ids", np.asarray(obj_ids)), ("heatBBox", hb),
                            ("heatPoint", hp), ("centerPoint", cp)))
        print(f"done {vdir.name}", flush=True)


def get_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("ocpg_tpu_torch.preprocess.generate_anno",
                                description="Pseudo-label generation (the PyTorch port "
                                            "of ocpg_tpu.preprocess.generate_anno).")
    p.add_argument("--dataset", choices=["a2d", "ytvos"], required=True)
    p.add_argument("--root", required=True)
    p.add_argument("--densecl", default=None, help="DenseCL ResNet-101 torch checkpoint")
    p.add_argument("--crf", action="store_true", help="apply the dense-CRF refinement")
    p.add_argument("--device", default="cuda",
                   help="torch device of the sim model (cpu for the tests)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = get_args(argv)

    from .sim_model import init_sim_model, load_resnet_weights

    model = init_sim_model(device=args.device)
    if args.densecl:
        from ..utils.torch_weights import load_torch_file

        load_resnet_weights(model, load_torch_file(args.densecl))
    if args.dataset == "a2d":
        run_a2d(args.root, model, args.crf)
    else:
        run_ytvos(args.root, model, args.crf)


if __name__ == "__main__":
    main()
