"""Dataset readers: counterpart of ``ocpg_tpu/data/datasets.py``.

Ref-YouTube-VOS, A2D-Sentences, JHMDB-Sentences and Ref-DAVIS17 readers on
the host, each producing ``transforms.Clip`` records with the reference's
target schema:

* YTVOS: ``meta_expressions.json`` parsed into one meta per (expression,
  anchor frame); frames sampled as the anchor, two local (+-1..3) and
  global random ones, reversed with probability 0.3; JPEG frames, palette
  PNG masks, weak heatmaps from ``AnnotationsWeakly/*.h5``.
* A2D: mp4 clips with one annotated frame per clip (``valid_indices``);
  masks and ``heatBBox`` / ``heatPoint`` from h5; the val window centred on
  the annotated frame.
* JHMDB: eval only, frame PNGs and ``.mat`` puppet masks, a centred window.
* DAVIS: YTVOS-style metas with full masks.

Quirks of the reference kept on purpose: YTVOS box supervision reads
``heatPoint`` for both box and point modes, while A2D reads ``heatBBox``
for box.  Two faults of the reference, which the JAX package keeps, are
repaired: A2D's point-supervised box is ``weight2mask``'s pixel box (the
reference scales it by (w, h) once more, so no clip stays valid), and the
loader (``transforms.pad_to_canvas``) keeps an A2D clip's targets to its
annotated frame instead of repeating them over the clip.

The JAX package reads the h5 files with h5py, imported when the module
loads; here ``h5.read_datasets`` (numpy and the standard library) reads
only the datasets each reader needs, so no h5py is needed.  The other
packages are imported by the reader call that needs them: cv2 by the A2D
reader's mp4 decode, scipy by the JHMDB reader, PIL only where
``imageio`` hands a file to it.  A missing package raises
``ImportError`` naming it at that call.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .h5 import read_datasets
from .imageio import read_palette, read_rgb
from .transforms import Clip


def center_of_mass(bitmask: np.ndarray) -> Tuple[float, float]:
    """Pixel-unit centroid (util/box_ops.py:114-125)."""
    h, w = bitmask.shape[-2:]
    ys = np.arange(h, dtype=np.float32)
    xs = np.arange(w, dtype=np.float32)
    m00 = max(bitmask.sum(), 1e-6)
    cx = float((bitmask * xs).sum() / m00)
    cy = float((bitmask * ys[:, None]).sum() / m00)
    return cx, cy


def weight2mask(heatmaps: np.ndarray, instance_idx: int, thres: float = 0.5
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Pseudo mask + box from per-instance heatmaps (ytvos.py:22-38).

    heatmaps: (n, h, w).  The mask is the argmax over instances vs a constant
    background of `thres`; the box is derived from the mask's x/y projections
    (pixel units).
    """
    n, h, w = heatmaps.shape
    stacked = np.concatenate([heatmaps, np.full((1, h, w), thres, heatmaps.dtype)], 0)
    final = (stacked.argmax(0) == instance_idx).astype(np.float32)
    width_proj = final.max(axis=0)    # (w,)
    height_proj = final.max(axis=1)   # (h,)
    bw = width_proj.sum()
    bh = height_proj.sum()
    cx, _ = center_of_mass(width_proj[None, :])
    _, cy = center_of_mass(height_proj[:, None])
    box = np.array([cx - 0.5 * bw, cy - 0.5 * bh, cx + 0.5 * bw, cy + 0.5 * bh], np.float32)
    return final, box


def sample_frame_indices(frame_id: int, vid_len: int, num_frames: int,
                         rng: random.Random, reverse_p: float = 0.3,
                         train: bool = True) -> List[int]:
    """Anchor + local(±1..3) + global-random sampling (ytvos.py:133-162)."""
    sample = [frame_id]
    if num_frames != 1:
        before = rng.randint(1, 3)
        after = rng.randint(1, 3)
        sample.extend([max(0, frame_id - before), min(vid_len - 1, frame_id + after)])
        if num_frames > 3:
            all_inds = list(range(vid_len))
            global_inds = all_inds[:min(sample)] + all_inds[max(sample):]
            global_n = num_frames - len(sample)
            if len(global_inds) > global_n:
                sample += rng.sample(global_inds, global_n)
            elif vid_len >= global_n:
                sample += rng.sample(all_inds, global_n)
            else:
                ids = rng.sample(all_inds, global_n - vid_len) + all_inds
                sample += ids
    sample.sort()
    if train and rng.random() < reverse_p:
        sample = sample[::-1]
    return sample


def mask_bounding_box(mask: np.ndarray) -> Tuple[float, float, float, float]:
    ys, xs = np.where(mask > 0)
    return float(xs.min()), float(ys.min()), float(xs.max()), float(ys.max())


@dataclass
class ClipRecord:
    clip: Clip
    valid_indices: Optional[int] = None   # annotated-frame position (a2d/jhmdb)
    video: str = ""
    frame_names: Sequence[str] = ()
    exp_id: str = ""


class YTVOSDataset:
    """Ref-YouTube-VOS train reader."""

    def __init__(self, root: str, num_frames: int = 3, supervision: str = "box",
                 split: str = "train"):
        self.root = Path(root)
        self.img_folder = self.root / split
        self.num_frames = num_frames
        self.supervision = supervision
        meta_file = self.root / "meta_expressions" / split / "meta_expressions.json"
        with open(meta_file) as f:
            data = json.load(f)["videos"]
        self.metas = []
        for vid, vd in data.items():
            frames = sorted(vd["frames"])
            for eid, ed in vd["expressions"].items():
                # one meta per (expression, anchor frame) as in ytvos.py:79-110
                for fi in range(len(frames)):
                    self.metas.append({
                        "video": vid, "exp": ed["exp"], "obj_id": int(ed["obj_id"]),
                        "frames": frames, "frame_id": fi, "exp_id": eid,
                    })

    def __len__(self):
        return len(self.metas)

    def get_clip(self, idx: int, rng: random.Random) -> ClipRecord:
        """Retry-until-valid is the caller's job (the loader's)."""
        meta = self.metas[idx]
        frames = meta["frames"]
        obj_id = meta["obj_id"]
        sample = sample_frame_indices(meta["frame_id"], len(frames), self.num_frames, rng)

        imgs, boxes, masks, valids, weak_masks, weights = [], [], [], [], [], []
        for fi in sample:
            name = frames[fi]
            img = read_rgb(self.img_folder / "JPEGImages" / meta["video"] / f"{name}.jpg")
            pal = read_palette(self.img_folder / "Annotations" / meta["video"] / f"{name}.png")
            mask = (pal == obj_id).astype(np.float32)
            weak = read_datasets(self.img_folder / "AnnotationsWeakly" / meta["video"]
                                 / f"{name}.h5", ("heatPoint", "obj_ids"))
            # NOTE: box mode reads heatPoint as in the reference (ytvos.py:175-178)
            heatmaps = np.asarray(weak["heatPoint"], np.float32)
            obj_ids = [int(o) for o in weak["obj_ids"]]
            if obj_id in obj_ids:
                inst = obj_ids.index(obj_id)
                weak_mask, weak_box = weight2mask(heatmaps, inst)
                heat = heatmaps[inst]
            else:
                weak_mask = np.zeros(heatmaps.shape[-2:], np.float32)
                heat = np.zeros(heatmaps.shape[-2:], np.float32)
                weak_box = None
            if (mask > 0).any():
                box = np.array(mask_bounding_box(mask), np.float32)
                if self.supervision == "point" and weak_box is not None:
                    box = weak_box
                valids.append(1)
            else:
                box = np.zeros(4, np.float32)
                valids.append(0)
            imgs.append(img)
            boxes.append(box)
            masks.append(mask)
            weak_masks.append(weak_mask)
            weights.append(heat)

        clip = Clip(
            frames=np.stack(imgs).astype(np.float32),
            boxes=np.stack(boxes),
            masks=np.stack(masks),
            weak_masks=np.stack(weak_masks),
            weights=np.stack(weights),
            valid=np.asarray(valids, np.int32),
            labels=np.zeros(len(sample), np.int32),
            caption=" ".join(meta["exp"].lower().split()),
        )
        return ClipRecord(clip, video=meta["video"],
                          frame_names=[frames[i] for i in sample], exp_id=meta["exp_id"])


class A2DSentencesDataset:
    """A2D-Sentences reader (mp4 clips, one annotated frame per clip)."""

    def __init__(self, root: str, num_frames: int = 3, supervision: str = "box",
                 split: str = "train"):
        self.root = Path(root)
        self.num_frames = num_frames
        self.supervision = supervision
        self.split = split
        self.videos_dir = self.root / "Release" / "clips320H"
        self.mask_dir = self.root / "text_annotations" / "a2d_annotation_with_instances"
        # instances: tsv "video_id,instance_id,text_query" filtered by split
        ann = self.root / "text_annotations" / "a2d_annotation.txt"
        import csv

        split_ids = self._split_videos()
        self.samples: List[Tuple[str, str, str, int]] = []
        if ann.exists():
            with open(ann) as f:
                reader = csv.reader(f)
                next(reader, None)
                rows = list(reader)
            for video_id, instance_id, query in rows:
                if split_ids and video_id not in split_ids:
                    continue
                d = self.mask_dir / video_id
                if not d.exists():
                    continue
                for hf in sorted(d.glob("*.h5")):
                    frame_idx = int(hf.stem)
                    instances = [int(x) for x in
                                 np.atleast_1d(read_datasets(hf, ("instance",))["instance"])]
                    if int(instance_id) in instances:
                        self.samples.append((video_id, instance_id, query, frame_idx))

    def _split_videos(self):
        csv_path = self.root / "Release" / "videoset.csv"
        if not csv_path.exists():
            return set()
        want = "0" if self.split == "train" else "1"
        out = set()
        with open(csv_path) as f:
            for line in f:
                parts = line.strip().split(",")
                if parts and parts[-1] == want:
                    out.add(parts[0])
        return out

    def __len__(self):
        return len(self.samples)

    def _read_video(self, video_id: str) -> np.ndarray:
        import cv2

        cap = cv2.VideoCapture(str(self.videos_dir / f"{video_id}.mp4"))
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        cap.release()
        return np.stack(frames)

    def get_clip(self, idx: int, rng: random.Random) -> ClipRecord:
        video_id, instance_id, query, frame_idx = self.samples[idx]
        video = self._read_video(video_id)
        vid_len = len(video)
        frame_id = frame_idx - 1  # 1-indexed source (a2d.py:104)

        if self.split == "train":
            sample = sample_frame_indices(frame_id, vid_len, self.num_frames, rng,
                                          reverse_p=0.0, train=True)
        else:
            sample = [min(max(i, 0), vid_len - 1)
                      for i in range(frame_id - self.num_frames // 2,
                                     frame_id + (self.num_frames + 1) // 2)]
            sample.sort()
        valid_indices = sample.index(frame_id)

        imgs = [video[i] for i in sample]
        h, w = imgs[0].shape[:2]

        key = "heatBBox" if self.supervision == "box" else "heatPoint"
        ann = read_datasets(self.mask_dir / video_id / f"{frame_idx:05d}.h5",
                            ("instance", "reMask", key))
        instances = [int(x) for x in np.atleast_1d(ann["instance"])]
        inst = instances.index(int(instance_id))
        inst_masks = ann["reMask"]
        heatmaps = np.asarray(ann[key], np.float32)
        if inst_masks.ndim == 2:
            inst_masks = inst_masks[None]
        inst_masks = np.transpose(inst_masks, (0, 2, 1))  # stored transposed (a2d.py:186)

        # the pseudo box in pixels, as the Ref-YTVOS reader keeps it.  The
        # reference (a2d.py:178-180) and the JAX package scale this pixel box
        # by (w, h) once more, which clips it to the image's corner: no
        # point-supervised clip then survives the transforms, and the loader
        # gives up after 20 draws
        weak_mask, weak_box = weight2mask(heatmaps, inst)

        mask = inst_masks[inst].astype(np.float32)
        if (mask > 0).any():
            box = np.array(mask_bounding_box(mask), np.float32)
            if self.supervision == "point":
                box = weak_box
            valid = 1
        else:
            box, valid = np.zeros(4, np.float32), 0
        box[0::2] = box[0::2].clip(0, w)
        box[1::2] = box[1::2].clip(0, h)

        clip = Clip(
            frames=np.stack(imgs).astype(np.float32),
            boxes=np.tile(box, (1, 1)),
            masks=mask[None],
            weak_masks=weak_mask[None],
            weights=heatmaps[inst][None],
            valid=np.asarray([valid], np.int32),
            labels=np.zeros(1, np.int32),
            caption=" ".join(query.lower().split()),
        )
        return ClipRecord(clip, valid_indices=valid_indices, video=video_id,
                          frame_names=[str(i) for i in sample])


class JHMDBSentencesDataset:
    """JHMDB-Sentences (eval-only; frame PNGs + .mat puppet masks, jhmdb.py:35-94).

    Sampling is deterministic: the reference enumerates fixed
    (video, chosen-frame) samples from `jhmdb_sentences_samples_metadata.json`
    (jhmdb.py:48-51,64-81); we read the same file when present.  The fallback
    (annotation txt only) derives the annotated frame from a per-sample seeded
    RNG so two eval runs produce identical metrics.
    """

    def __init__(self, root: str, num_frames: int = 3):
        self.root = Path(root)
        self.num_frames = num_frames
        self.samples = []
        meta = self.root / "jhmdb_sentences_samples_metadata.json"
        if meta.exists():
            with open(meta) as f:
                # (video_id, chosen_frame_path, masks_path, total_frames, query)
                for video_id, frame_path, _, _, query in json.load(f):
                    frame_id = int(Path(frame_path).stem) - 1  # 1-indexed source
                    self.samples.append((video_id, query, frame_id))
        else:
            ann = self.root / "jhmdb_annotation.txt"
            if ann.exists():
                import csv

                with open(ann) as f:
                    reader = csv.reader(f)
                    next(reader, None)
                    for video_id, query in reader:
                        self.samples.append((video_id, query, None))

    def __len__(self):
        return len(self.samples)

    def get_clip(self, idx: int, rng: random.Random) -> ClipRecord:
        from scipy.io import loadmat

        video_id, query, frame_id = self.samples[idx]
        frames_dir = next((self.root / "Rename_Images").glob(f"*/{video_id}"))
        frame_files = sorted(frames_dir.glob("*.png"))
        video = np.stack([read_rgb(p) for p in frame_files])
        mat = loadmat(str(next((self.root / "puppet_mask").glob(f"*/{video_id}/puppet_mask.mat"))))
        puppet = np.asarray(mat["part_mask"])  # (H, W, T_annot)
        t_annot = puppet.shape[-1]
        if frame_id is None:
            # deterministic per-sample choice (NOT the caller's epoch rng)
            frame_id = random.Random(idx).randint(0, t_annot - 1) if t_annot > 1 else 0
        frame_id = min(frame_id, t_annot - 1)
        sample = [min(max(i, 0), len(video) - 1)
                  for i in range(frame_id - self.num_frames // 2,
                                 frame_id + (self.num_frames + 1) // 2)]
        sample.sort()
        valid_indices = sample.index(frame_id)
        mask = (puppet[:, :, frame_id] > 0).astype(np.float32)
        box = np.array(mask_bounding_box(mask), np.float32) if mask.any() else np.zeros(4, np.float32)
        clip = Clip(
            frames=np.stack([video[i] for i in sample]).astype(np.float32),
            boxes=box[None],
            masks=mask[None],
            weak_masks=mask[None],
            weights=mask[None],
            valid=np.asarray([int(mask.any())], np.int32),
            labels=np.zeros(1, np.int32),
            caption=" ".join(query.lower().split()),
        )
        return ClipRecord(clip, valid_indices=valid_indices, video=video_id)


class DAVISDataset:
    """Ref-DAVIS17 (fully-supervised masks, ytvos-style metas, davis.py:84-181)."""

    def __init__(self, root: str, num_frames: int = 3, split: str = "train"):
        self.root = Path(root)
        self.img_folder = self.root / split
        self.num_frames = num_frames
        meta_file = self.root / "meta_expressions" / split / "meta_expressions.json"
        with open(meta_file) as f:
            data = json.load(f)["videos"]
        self.metas = []
        for vid, vd in data.items():
            frames = sorted(vd["frames"])
            for eid, ed in vd["expressions"].items():
                for fi in range(len(frames)):
                    self.metas.append({
                        "video": vid, "exp": ed["exp"], "obj_id": int(ed["obj_id"]),
                        "frames": frames, "frame_id": fi, "exp_id": eid,
                    })

    def __len__(self):
        return len(self.metas)

    def get_clip(self, idx: int, rng: random.Random) -> ClipRecord:
        meta = self.metas[idx]
        frames = meta["frames"]
        obj_id = meta["obj_id"]
        sample = sample_frame_indices(meta["frame_id"], len(frames), self.num_frames, rng)
        imgs, boxes, masks, valids = [], [], [], []
        for fi in sample:
            name = frames[fi]
            img = read_rgb(self.img_folder / "JPEGImages" / meta["video"] / f"{name}.jpg")
            pal = read_palette(self.img_folder / "Annotations" / meta["video"] / f"{name}.png")
            mask = (pal == obj_id).astype(np.float32)
            if mask.any():
                boxes.append(np.array(mask_bounding_box(mask), np.float32))
                valids.append(1)
            else:
                boxes.append(np.zeros(4, np.float32))
                valids.append(0)
            imgs.append(img)
            masks.append(mask)
        m = np.stack(masks)
        clip = Clip(
            frames=np.stack(imgs).astype(np.float32),
            boxes=np.stack(boxes),
            masks=m,
            weak_masks=m.copy(),     # full supervision: weak == GT
            weights=m.copy(),
            valid=np.asarray(valids, np.int32),
            labels=np.zeros(len(sample), np.int32),
            caption=" ".join(meta["exp"].lower().split()),
        )
        return ClipRecord(clip, video=meta["video"],
                          frame_names=[frames[i] for i in sample], exp_id=meta["exp_id"])


def build_dataset(name: str, root: str, split: str, num_frames: int,
                  supervision: str = "box", coco_path: str = None,
                  coco_ann_dir: str = None, davis_path: str = None):
    """Registry (datasets/__init__.py:23-51), including the joint-training
    concats (concat_dataset.py:19-62):

    - ``joint``: refcoco/+/g as pseudo-video clips ⊕ ytvos (``root`` is the
      ytvos root; needs ``coco_path`` and optionally ``coco_ann_dir``)
    - ``joint_coco``: refcoco/+/g pseudo-video only
    - ``ytvos_joint_davis``: davis ×5 ⊕ ytvos (the ×5 oversampling matches
      build_joint_ytb_dvs, concat_dataset.py:48-62)
    """
    if name == "ytvos":
        return YTVOSDataset(root, num_frames, supervision, split)
    if name == "a2d":
        return A2DSentencesDataset(root, num_frames, supervision, split)
    if name == "jhmdb":
        return JHMDBSentencesDataset(root, num_frames)
    if name == "davis":
        return DAVISDataset(root, num_frames, split)
    if name in ("joint", "joint_coco", "ytvos_joint_davis"):
        from .refexp import ConcatClipDataset, RefExpDataset

        parts = []
        if name in ("joint", "joint_coco"):
            if not coco_path:
                raise ValueError(f"dataset '{name}' needs coco_path")
            ann_dir = Path(coco_ann_dir or coco_path)
            for n in ("refcoco", "refcoco+", "refcocog"):
                parts.append(RefExpDataset(
                    str(Path(coco_path) / "train2014"),
                    str(ann_dir / f"instances_{n}_{split}.json"),
                    num_frames=num_frames, as_sequence=num_frames > 1))
        if name == "ytvos_joint_davis":
            if not davis_path:
                raise ValueError("dataset 'ytvos_joint_davis' needs davis_path")
            dvs = DAVISDataset(davis_path, num_frames, split)
            parts.extend([dvs] * 5)
        if name in ("joint", "ytvos_joint_davis"):
            parts.append(YTVOSDataset(root, num_frames, supervision, split))
        return ConcatClipDataset(parts)
    raise ValueError(f"unknown dataset {name}")
