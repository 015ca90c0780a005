"""DAVIS 2017 evaluation harness (J&F over saved PNG results): the port's
copy of ``ocpg_tpu/evaluation/davis_eval.py``.

The official davis2017 toolkit's DAVIS reader with void-mask extraction
(davis.py:83-98), its Results PNG reader (results.py:22-31), the
semi-supervised and unsupervised protocols with per-sequence Hungarian
matching of proposals (evaluation.py:27-64), and the mean/recall/decay
statistics (utils.py:133-160), in numpy.

Void pixels (palette index 255) are excluded from both J and F in the
unsupervised protocol; the semi-supervised protocol passes no void masks,
as the toolkit's call at evaluation.py:90 hands ``None`` to
``_evaluate_semisupervised``.
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

from .davis_metrics import db_eval_boundary, db_eval_iou
from ..data.imageio import read_palette


def db_statistics(per_frame: np.ndarray) -> Tuple[float, float, float]:
    """(mean, recall@0.5, decay) over the given per-frame values
    (davis2017/utils.py:133-160).  Decay = mean of the first quarter of
    frames minus mean of the last quarter.

    Frame dropping is NOT done here — the semi-supervised caller strips the
    first/last frames before computing metrics (evaluation.py:84-85).

    Deviation from the reference, on purpose: the reference casts the bin
    indices to uint8 (utils.py:151), silently corrupting the decay statistic
    for sequences longer than 255 frames; we keep int64 indices.  DAVIS val
    sequences are <105 frames, so results are identical on real data.
    """
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        M = np.nanmean(per_frame)
        R = np.nanmean(per_frame > 0.5)
    n_bins = 4
    ids = np.round(np.linspace(1, len(per_frame), n_bins + 1) + 1e-10) - 1
    ids = ids.astype(np.int64)
    d_bins = [per_frame[ids[i]:ids[i + 1] + 1] for i in range(n_bins)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        D = np.nanmean(d_bins[0]) - np.nanmean(d_bins[3])
    return float(M), float(R), float(D)


class DavisDataset:
    """Standard DAVIS17 layout reader: JPEGImages/, Annotations/, ImageSets/2017/."""

    VOID_LABEL = 255   # davis2017/davis.py:12

    def __init__(self, root: str, subset: str = "val", task: str = "unsupervised"):
        self.root = Path(root)
        self.task = task
        anno_dir = "Annotations_unsupervised" if task == "unsupervised" else "Annotations"
        self.anno_root = self.root / anno_dir
        if not self.anno_root.exists():
            self.anno_root = self.root / "Annotations"
        split_file = self.root / "ImageSets" / "2017" / f"{subset}.txt"
        if split_file.exists():
            self.sequences = [l.strip() for l in open(split_file) if l.strip()]
        else:
            self.sequences = sorted(p.name for p in self.anno_root.iterdir() if p.is_dir())

    def get_all_masks(self, seq: str) -> Tuple[np.ndarray, np.ndarray, List[str]]:
        """Per-object GT masks (num_obj, T, H, W), per-frame void masks
        (T, H, W), and frame ids (davis2017/davis.py:83-98).

        Void pixels (label 255) are split out and zeroed from the id map;
        objects are ids 1..max(first frame), the reference's convention
        (davis.py:93)."""
        files = sorted((self.anno_root / seq).glob("*.png"))
        ids = [f.stem for f in files]
        frames = np.stack([read_palette(f) for f in files])
        void = frames == self.VOID_LABEL
        frames = np.where(void, 0, frames)
        num_objects = int(frames[0].max())
        masks = np.stack([(frames == o).astype(np.float32)
                          for o in range(1, num_objects + 1)]) \
            if num_objects else np.zeros((0,) + frames.shape, np.float32)
        return masks, void.astype(np.float32), ids


class ResultsReader:
    def __init__(self, root: str):
        self.root = Path(root)

    def read_masks(self, seq: str, frame_ids: Sequence[str], num_objects: int) -> np.ndarray:
        """Per-proposal masks (n_res, T, H, W): proposals are palette ids
        1..max over the whole sequence (davis2017/results.py:22-31).
        Missing frames read as all-background rather than aborting."""
        first = read_palette(self.root / seq / f"{frame_ids[0]}.png")
        frames = np.zeros((len(frame_ids),) + first.shape, first.dtype)
        for i, fid in enumerate(frame_ids):
            p = self.root / seq / f"{fid}.png"
            if p.exists():
                frames[i] = read_palette(p)
        n_res = int(frames.max())
        return np.stack([(frames == o).astype(np.float32)
                         for o in range(1, n_res + 1)]) \
            if n_res else np.zeros((0,) + frames.shape, np.float32)


MAX_N_PROPOSALS = 20   # davis2017/evaluation.py:44


def evaluate_davis(davis_root: str, results_path: str, subset: str = "val",
                   task: str = "unsupervised") -> Dict:
    """DAVISEvaluation.evaluate equivalent (davis2017/evaluation.py:66-110)."""
    dataset = DavisDataset(davis_root, subset, task)
    results = ResultsReader(results_path)
    metrics = {
        "J": {"M": [], "R": [], "D": [], "M_per_object": {}},
        "F": {"M": [], "R": [], "D": [], "M_per_object": {}},
    }
    for seq in dataset.sequences:
        gt_masks, void_masks, frame_ids = dataset.get_all_masks(seq)
        if gt_masks.shape[0] == 0:
            continue
        if task == "semi-supervised":
            # First/last frames are dropped from scoring (evaluation.py:84-85).
            gt_masks, frame_ids = gt_masks[:, 1:-1], frame_ids[1:-1]
        res_masks = results.read_masks(seq, frame_ids, gt_masks.shape[0])
        if task == "unsupervised" and res_masks.shape[0] > MAX_N_PROPOSALS:
            raise ValueError(
                f"{seq}: {res_masks.shape[0]} proposals exceed the maximum "
                f"of {MAX_N_PROPOSALS} (davis2017/evaluation.py:45-47)")
        if task == "semi-supervised" and res_masks.shape[0] > gt_masks.shape[0]:
            raise ValueError(
                f"{seq}: result PNGs contain an object index higher than the "
                f"number of GT objects (davis2017/evaluation.py:29-31)")
        if res_masks.shape[0] < gt_masks.shape[0]:
            pad = np.zeros((gt_masks.shape[0] - res_masks.shape[0],) + res_masks.shape[1:])
            res_masks = np.concatenate([res_masks, pad], axis=0)

        if task == "unsupervised":
            n_res, n_gt = res_masks.shape[0], gt_masks.shape[0]
            j = np.zeros((n_res, n_gt, gt_masks.shape[1]))
            f = np.zeros_like(j)
            for ii in range(n_gt):
                for jj in range(n_res):
                    j[jj, ii] = db_eval_iou(gt_masks[ii], res_masks[jj], void_masks)
                    f[jj, ii] = db_eval_boundary(gt_masks[ii], res_masks[jj], void_masks)
            score = (j.mean(axis=2) + f.mean(axis=2)) / 2
            row, col = linear_sum_assignment(-score)
            j_res, f_res = j[row, col], f[row, col]
        else:
            # Reference quirk kept: void masks are NOT applied here — the
            # semi-supervised call hands None (evaluation.py:90).
            n_gt = gt_masks.shape[0]
            j_res = np.stack([db_eval_iou(gt_masks[i], res_masks[i]) for i in range(n_gt)])
            f_res = np.stack([db_eval_boundary(gt_masks[i], res_masks[i]) for i in range(n_gt)])

        for ii in range(gt_masks.shape[0]):
            name = f"{seq}_{ii + 1}"
            for key, arr in (("J", j_res), ("F", f_res)):
                m, r, d = db_statistics(arr[ii])
                metrics[key]["M"].append(m)
                metrics[key]["R"].append(r)
                metrics[key]["D"].append(d)
                metrics[key]["M_per_object"][name] = m
    return metrics


def global_summary(metrics: Dict) -> Dict[str, float]:
    J, F = metrics["J"], metrics["F"]
    return {
        "J&F-Mean": (float(np.mean(J["M"])) + float(np.mean(F["M"]))) / 2,
        "J-Mean": float(np.mean(J["M"])), "J-Recall": float(np.mean(J["R"])),
        "J-Decay": float(np.mean(J["D"])), "F-Mean": float(np.mean(F["M"])),
        "F-Recall": float(np.mean(F["R"])), "F-Decay": float(np.mean(F["D"])),
    }
