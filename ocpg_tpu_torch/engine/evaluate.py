"""A2D/JHMDB and RefCOCO evaluation loops on one device: counterpart of
``ocpg_tpu/engine/evaluate.py`` without the mesh.

The reference's eval loop: forward, postprocess to RLE at the dataset's
native resolution, COCO-style segm metrics with P@K and IoU
(``evaluation/a2d_metrics.py``), and for RefCOCO the referring box P@k and
COCO bbox stats.  Batches may come in the compact wire (uint8 frames):
they are normalised on the device (``data/loader.normalize_frames``), as in
``engine/infer.py``.

``evaluate_a2d(postprocess="device")`` (the default) runs the postprocess
on the device after the forward: each sample's mask logits are cropped to
its valid region, resized to its original size inside a /64-aligned
output bucket, thresholded and packed 8 pixels a byte, the first pixel in
the most significant bit (``np.unpackbits``-compatible).  The JAX function
builds its resize matrices from traced sizes because XLA needs static
shapes; here the sizes are known on the host, so each sample's static
bilinear matrix (``ops/image._resize_matrix``) is embedded in the bucket,
zero outside the valid region.  The two products are float32 matmuls with
TF32 off.  The batches are double-buffered: batch i is read back (pinned
memory, a CUDA event) only after batch i+1 is enqueued.  ``"host"`` reads
back the full-canvas logits (``readback="f16"`` casts only ``pred_masks``)
and postprocesses them with ``models/postprocessors.py``.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..data.loader import normalize_frames
from ..evaluation.a2d_metrics import evaluate_a2d as _metrics
from ..evaluation.coco_eval import CocoEvaluatorLite
from ..evaluation.refexp_metrics import evaluate_refexp as _refexp_metrics
from ..evaluation.rle import rle_encode
from ..models.build import resolve_device
from ..models.postprocessors import a2d_postprocess, refcoco_postprocess
from ..ops.image import _resize_matrix
from .infer import readback as to_host
from .infer import upload

# np.unpackbits order: the first pixel of a byte in its most significant bit
_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


@contextlib.contextmanager
def _full_float32_matmul():
    """TF32 off for the products inside (the masks are thresholded at 0)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _forward(model, batch: Dict, device: torch.device, valid_indices: bool):
    """The eval forward of one loader batch (compact or float32 wire)."""
    smask = upload(batch["samples_mask"], device)
    args = [normalize_frames(upload(batch["samples"], device), smask), smask,
            upload(batch["text_ids"], device), upload(batch["text_mask"], device),
            upload(batch["targets"]["size"], device)]
    vi = None
    if valid_indices:
        vi = upload(_valid_indices(batch), device)
    with torch.no_grad():
        return model(*args, valid_indices=vi)


def _valid_indices(batch: Dict) -> np.ndarray:
    return np.asarray(batch.get("valid_indices",
                                np.zeros(len(batch["samples"]), np.int32)), np.int32)


def _gt_mask(batch: Dict, i: int, t_annot: int) -> np.ndarray:
    """Sample i's ground truth at the dataset's native resolution."""
    orig_masks = batch.get("orig_masks")
    if orig_masks is not None:
        return orig_masks[i][min(t_annot, orig_masks[i].shape[0] - 1)]
    h, w = np.asarray(batch["targets"]["size"])[i]
    return np.asarray(batch["targets"]["masks"])[i, t_annot, :h, :w]


def _t_annot(batch: Dict, vi: np.ndarray, i: int) -> int:
    return 0 if np.shape(batch["targets"]["masks"])[1] == 1 else int(vi[i])


def embedded_resize_matrix(src_len: int, dst_len: int, valid_src: int,
                           valid_dst: int) -> np.ndarray:
    """(dst_len, src_len) float32: the bilinear ``align_corners=False``
    matrix from ``valid_src`` to ``valid_dst`` in its top-left corner and
    zero elsewhere, so applying it to the padded canvas equals resizing the
    cropped valid region (the JAX function's ``_resize_matrix_traced``)."""
    m = np.zeros((dst_len, src_len), np.float32)
    m[:valid_dst, :valid_src] = _resize_matrix(int(valid_src), int(valid_dst),
                                               "bilinear", False)
    return m


def output_bucket(orig_sizes: np.ndarray) -> Tuple[int, int]:
    """The /64-aligned bucket that holds every original size of a batch."""
    return (int(-(-int(orig_sizes[:, 0].max()) // 64) * 64),
            int(-(-int(orig_sizes[:, 1].max()) // 64) * 64))


def device_postprocess(pred_masks: torch.Tensor, sizes: np.ndarray,
                       orig_sizes: np.ndarray, out_bucket: Tuple[int, int]) -> torch.Tensor:
    """(B, 1, Q, H, W) canvas mask logits -> (B, Q, OBH, OBW // 8) uint8: each
    sample's valid region resized to its original size, sigmoid > 0.5,
    packed 8 pixels a byte (first pixel in the MSB); rows and columns past
    the original size are 0."""
    obh, obw = out_bucket
    masks = pred_masks[:, 0].float()                                  # (B, Q, H, W)
    b, q, hc, wc = masks.shape
    dev = masks.device
    mh = np.stack([embedded_resize_matrix(hc, obh, s[0], o[0])
                   for s, o in zip(sizes, orig_sizes)])              # (B, OBH, H)
    mw = np.stack([embedded_resize_matrix(wc, obw, s[1], o[1])
                   for s, o in zip(sizes, orig_sizes)])              # (B, OBW, W)
    with _full_float32_matmul():
        y = torch.matmul(upload(mh, dev)[:, None], masks)           # (B, Q, OBH, W)
        y = torch.matmul(y, upload(mw, dev)[:, None].transpose(-1, -2))
    binary = (torch.sigmoid(y) > 0.5).to(torch.uint8)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=dev)
    return (binary.reshape(b, q, obh, obw // 8, 8) * weights).sum(-1).to(torch.uint8)


def evaluate_a2d(model, loader, invert_masks: bool = False, readback: str = "f32",
                 postprocess: str = "device",
                 device: Optional[Union[str, torch.device]] = None) -> Dict[str, float]:
    """The A2D/JHMDB metrics of ``model`` over one epoch of ``loader``
    (``loader.epoch(0)``; a padded tail batch says ``real_count``)."""
    device = resolve_device(device)
    if postprocess == "device":
        return _evaluate_a2d_device(model, loader, invert_masks, device)
    if postprocess != "host":
        raise ValueError(f"postprocess must be 'device' or 'host', got {postprocess!r}")
    mask_dtype = torch.float16 if readback == "f16" else torch.float32

    predictions: List[Dict] = []
    ground_truths: List[Dict] = []
    img_counter = 0
    for batch in loader.epoch(0):
        real = int(batch.get("real_count", len(batch["samples"])))
        out = _forward(model, batch, device, valid_indices=True)
        logits = out["pred_logits"].float().cpu().numpy()
        masks = out["pred_masks"].to(mask_dtype).cpu().numpy().astype(np.float32)
        sizes = np.asarray(batch["targets"]["size"])
        orig_sizes = np.asarray(batch["targets"].get("orig_size", sizes))
        results = a2d_postprocess(logits, masks, [tuple(s) for s in sizes],
                                  [tuple(s) for s in orig_sizes], invert_masks=invert_masks)
        vi = _valid_indices(batch)
        for i, res in enumerate(results[:real]):
            image_id = f"img_{img_counter}"
            img_counter += 1
            for q in range(len(res["scores"])):
                predictions.append({"image_id": image_id, "score": float(res["scores"][q]),
                                    "rle": res["rle_masks"][q]})
            gt = _gt_mask(batch, i, _t_annot(batch, vi, i))
            ground_truths.append({"image_id": image_id,
                                  "rle": rle_encode(gt.astype(np.uint8))})
    return _metrics(predictions, ground_truths)


def _evaluate_a2d_device(model, loader, invert_masks: bool,
                         device: torch.device) -> Dict[str, float]:
    """evaluate_a2d with the postprocess on the device (packed-binary wire)."""
    predictions: List[Dict] = []
    ground_truths: List[Dict] = []
    img_counter = 0

    def drain(item):
        nonlocal img_counter
        batch, vi, orig_sizes, real, logits, packed, event = item
        if event is not None:
            event.synchronize()
        logits = logits.numpy()
        packed = packed.numpy()                              # (B, Q, OBH, OBW // 8)
        scores_all = 1.0 / (1.0 + np.exp(-logits[:, 0, :, 0]))
        for i in range(real):
            oh, ow = orig_sizes[i]
            binary = np.unpackbits(packed[i], axis=-1)[:, :oh, :ow].astype(bool)
            if invert_masks:
                binary = ~binary
            image_id = f"img_{img_counter}"
            img_counter += 1
            for q in range(binary.shape[0]):
                predictions.append({"image_id": image_id, "score": float(scores_all[i, q]),
                                    "rle": rle_encode(binary[q].astype(np.uint8))})
            gt = _gt_mask(batch, i, _t_annot(batch, vi, i))
            ground_truths.append({"image_id": image_id,
                                  "rle": rle_encode(gt.astype(np.uint8))})

    inflight = collections.deque()
    for batch in loader.epoch(0):
        real = int(batch.get("real_count", len(batch["samples"])))
        vi = _valid_indices(batch)
        sizes = np.asarray(batch["targets"]["size"])
        orig_sizes = np.asarray(batch["targets"].get("orig_size", sizes))
        out = _forward(model, batch, device, valid_indices=True)
        packed = device_postprocess(out["pred_masks"], sizes, orig_sizes,
                                    output_bucket(orig_sizes))
        logits, packed = to_host(out["pred_logits"].float()), to_host(packed)
        event = None
        if device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        inflight.append((batch, vi, orig_sizes, real, logits, packed, event))
        if len(inflight) >= 2:
            drain(inflight.popleft())
    while inflight:
        drain(inflight.popleft())
    return _metrics(predictions, ground_truths)


def evaluate_refexp_loop(model, loader, readback: str = "f32",
                         device: Optional[Union[str, torch.device]] = None
                         ) -> Dict[str, float]:
    """RefCOCO val: referring box P@k (``bbox_*``), the A2D segm metrics
    (``segm_*``) and the COCO bbox stats (``coco_bbox_*``), all at the
    dataset's native resolution, as the reference's pretrain eval."""
    device = resolve_device(device)
    mask_dtype = torch.float16 if readback == "f16" else torch.float32
    box_preds: List[Dict] = []
    box_gts: List[Dict] = []
    segm_preds: List[Dict] = []
    segm_gts: List[Dict] = []
    img_counter = 0
    for batch in loader.epoch(0):
        real = int(batch.get("real_count", len(batch["samples"])))
        out = _forward(model, batch, device, valid_indices=False)
        logits = out["pred_logits"].float().cpu().numpy()
        boxes = out["pred_boxes"].float().cpu().numpy()
        masks = out["pred_masks"].to(mask_dtype).cpu().numpy().astype(np.float32)
        sizes = np.asarray(batch["targets"]["size"])
        orig_sizes = np.asarray(batch["targets"].get("orig_size", sizes))
        box_results = refcoco_postprocess(logits, boxes, [tuple(s) for s in orig_sizes])
        segm_results = a2d_postprocess(logits, masks, [tuple(s) for s in sizes],
                                       [tuple(s) for s in orig_sizes])
        gt_boxes = np.asarray(batch["targets"]["boxes"])     # normalized cxcywh
        for i in range(real):
            image_id = img_counter
            img_counter += 1
            box_preds.append({"image_id": image_id, "boxes": box_results[i]["boxes"],
                              "scores": box_results[i]["scores"]})
            oh, ow = orig_sizes[i]
            cx, cy, w, h = gt_boxes[i, 0]
            box_gts.append({"image_id": image_id, "box": np.asarray(
                [(cx - w / 2) * ow, (cy - h / 2) * oh, (cx + w / 2) * ow, (cy + h / 2) * oh],
                np.float32)})
            for q in range(len(segm_results[i]["scores"])):
                segm_preds.append({"image_id": image_id,
                                   "score": float(segm_results[i]["scores"][q]),
                                   "rle": segm_results[i]["rle_masks"][q]})
            segm_gts.append({"image_id": image_id,
                             "rle": rle_encode(_gt_mask(batch, i, 0).astype(np.uint8))})
    out = {f"bbox_{k}": v for k, v in _refexp_metrics(box_preds, box_gts).items()}
    out.update({f"segm_{k}": v for k, v in _metrics(segm_preds, segm_gts).items()})
    coco_dts = [{"image_id": p["image_id"], "score": float(s), "box": np.asarray(b, np.float64)}
                for p in box_preds for s, b in zip(p["scores"], p["boxes"])]
    coco_gts = [{"image_id": g["image_id"], "box": np.asarray(g["box"], np.float64)}
                for g in box_gts]
    out.update({f"coco_bbox_{k}": v
                for k, v in CocoEvaluatorLite("bbox").evaluate(coco_dts, coco_gts).items()})
    return out
