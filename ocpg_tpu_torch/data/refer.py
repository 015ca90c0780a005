"""Standalone REFER API, the classic refcoco/+/g referring-expression
loader: a copy of ``ocpg_tpu/data/refer.py``.

The reference's ``datasets/refer.py`` REFER class with its refs, anns,
imgs, cats and sents indices and their cross-maps, pycocotools-free: masks
decode through ``data/refexp.py::polygons_to_mask``.

Data layout (as published by the refer project):
    <data_root>/<dataset>/refs(<split_by>).p   pickled list of ref records
    <data_root>/<dataset>/instances.json      COCO-format images/anns/cats
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np


class REFER:
    def __init__(self, data_root: str, dataset: str = "refcoco",
                 split_by: str = "unc"):
        root = Path(data_root) / dataset
        with open(root / f"refs({split_by}).p", "rb") as f:
            refs = pickle.load(f)
        with open(root / "instances.json") as f:
            instances = json.load(f)

        self.data = {"dataset": dataset, "refs": refs,
                     "images": instances["images"],
                     "annotations": instances["annotations"],
                     "categories": instances.get("categories", [])}

        # flat indices
        self.Refs: Dict = {r["ref_id"]: r for r in refs}
        self.Anns: Dict = {a["id"]: a for a in instances["annotations"]}
        self.Imgs: Dict = {im["id"]: im for im in instances["images"]}
        self.Cats: Dict = {c["id"]: c["name"] for c in self.data["categories"]}
        self.Sents: Dict = {}
        # cross maps
        self.imgToRefs: Dict = {}
        self.imgToAnns: Dict = {}
        self.refToAnn: Dict = {}
        self.annToRef: Dict = {}
        self.catToRefs: Dict = {}
        self.sentToRef: Dict = {}
        self.sentToTokens: Dict = {}
        for a in instances["annotations"]:
            self.imgToAnns.setdefault(a["image_id"], []).append(a)
        for r in refs:
            self.imgToRefs.setdefault(r["image_id"], []).append(r)
            self.catToRefs.setdefault(r["category_id"], []).append(r)
            self.refToAnn[r["ref_id"]] = self.Anns[r["ann_id"]]
            self.annToRef[r["ann_id"]] = r
            for s in r["sentences"]:
                self.Sents[s["sent_id"]] = s
                self.sentToRef[s["sent_id"]] = r
                self.sentToTokens[s["sent_id"]] = s.get("tokens", s["sent"].split())

    # ------------------------------------------------------------- getters --
    def getRefIds(self, image_ids: Sequence = (), cat_ids: Sequence = (),
                  ref_ids: Sequence = (), split: str = "") -> List[int]:
        refs = self.data["refs"]
        if image_ids:
            want = set(image_ids)
            refs = [r for r in refs if r["image_id"] in want]
        if cat_ids:
            want = set(cat_ids)
            refs = [r for r in refs if r["category_id"] in want]
        if ref_ids:
            want = set(ref_ids)
            refs = [r for r in refs if r["ref_id"] in want]
        if split:
            if split in ("testA", "testB", "testC"):
                refs = [r for r in refs if split[-1] in r["split"]]
            elif split in ("testAB", "testBC", "testAC"):
                refs = [r for r in refs if r["split"] == split]
            elif split == "test":
                refs = [r for r in refs if "test" in r["split"]]
            else:
                refs = [r for r in refs if r["split"] == split]
        return [r["ref_id"] for r in refs]

    def getAnnIds(self, image_ids: Sequence = (), ref_ids: Sequence = ()) -> List[int]:
        if image_ids:
            anns = [a["id"] for i in image_ids for a in self.imgToAnns.get(i, [])]
        else:
            anns = [a["id"] for a in self.data["annotations"]]
        if ref_ids:
            want = {self.Refs[r]["ann_id"] for r in ref_ids}
            anns = [a for a in anns if a in want]
        return anns

    def getImgIds(self, ref_ids: Sequence = ()) -> List[int]:
        if ref_ids:
            return list({self.Refs[r]["image_id"] for r in ref_ids})
        return list(self.Imgs.keys())

    def getCatIds(self) -> List[int]:
        return list(self.Cats.keys())

    def loadRefs(self, ref_ids) -> List[Dict]:
        ids = ref_ids if isinstance(ref_ids, (list, tuple)) else [ref_ids]
        return [self.Refs[i] for i in ids]

    def loadAnns(self, ann_ids) -> List[Dict]:
        ids = ann_ids if isinstance(ann_ids, (list, tuple)) else [ann_ids]
        return [self.Anns[i] for i in ids]

    def loadImgs(self, image_ids) -> List[Dict]:
        ids = image_ids if isinstance(image_ids, (list, tuple)) else [image_ids]
        return [self.Imgs[i] for i in ids]

    def loadCats(self, cat_ids) -> List[str]:
        ids = cat_ids if isinstance(cat_ids, (list, tuple)) else [cat_ids]
        return [self.Cats[i] for i in ids]

    def getRefBox(self, ref_id: int) -> List[float]:
        return self.refToAnn[ref_id]["bbox"]  # xywh

    def getMask(self, ref: Dict) -> Dict[str, np.ndarray]:
        """Binary mask + area for one ref (polygon or RLE segmentation)."""
        from .refexp import polygons_to_mask

        ann = self.refToAnn[ref["ref_id"]]
        img = self.Imgs[ref["image_id"]]
        m = polygons_to_mask(ann.get("segmentation", []),
                             img["height"], img["width"]).astype(np.uint8)
        return {"mask": m, "area": float(m.sum())}
