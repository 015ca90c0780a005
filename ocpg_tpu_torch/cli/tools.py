"""Data and checkpoint tools: counterpart of ``ocpg_tpu/cli/tools.py``.

* ``refexp2coco``: REFER pickles (``refs(<split_by>).p`` and
  ``instances.json``) -> COCO-format referring-detection JSONs, one
  annotation per (ref, sentence), the sentence as the image's caption.
* ``davis2ytvos``: the Ref-DAVIS17 release -> the YTVOS layout
  (``JPEGImages/``, ``Annotations/``, ``meta_expressions.json`` per split)
  that the davis reader reads.
* ``convert_checkpoint``: a reference OCPG ``.pth`` -> a port
  ``checkpoints/`` directory, which every ``--checkpoint <dir>`` reads
  (``engine/checkpoint.load_params``).  The JAX tool writes an orbax
  directory; neither package reads the other's.

Usage:
    python -m ocpg_tpu_torch.cli.tools refexp2coco --refer_root /data/refer \\
        --dataset refcoco --output out/
    python -m ocpg_tpu_torch.cli.tools davis2ytvos --davis_root /data/ref-davis \\
        --output /data/ref-davis-ytvos
    python -m ocpg_tpu_torch.cli.tools convert_checkpoint --source ocpg_r101.pth \\
        --output checkpoints/ocpg_r101 --backbone resnet101
"""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path
from typing import Optional, Sequence


def refexp_to_coco(refer_root: str, dataset: str, split_by: str, output: str) -> None:
    from ..data.refer import REFER

    refer = REFER(refer_root, dataset, split_by)
    out_dir = Path(output)
    out_dir.mkdir(parents=True, exist_ok=True)
    for split in ("train", "val", "testA", "testB", "test"):
        split_refs = refer.loadRefs(refer.getRefIds(split=split))
        if not split_refs:
            continue
        images, annotations = [], []
        for r in split_refs:
            ann = refer.refToAnn[r["ref_id"]]
            im = refer.Imgs[r["image_id"]]
            for sent in r["sentences"]:
                image_id = len(images)
                images.append({
                    "id": image_id,
                    "file_name": im["file_name"],
                    "height": im["height"], "width": im["width"],
                    "caption": sent["sent"],
                    "original_id": im["id"],
                })
                annotations.append({
                    "id": len(annotations),
                    "image_id": image_id,
                    "bbox": ann["bbox"],
                    "segmentation": ann.get("segmentation", []),
                    "area": ann.get("area", ann["bbox"][2] * ann["bbox"][3]),
                    "iscrowd": ann.get("iscrowd", 0),
                    "category_id": ann["category_id"],
                })
        path = out_dir / f"instances_{dataset}_{split}.json"
        with open(path, "w") as f:
            json.dump({"images": images, "annotations": annotations,
                       "categories": refer.data["categories"]}, f)
        print(f"wrote {path} ({len(images)} image-sentence pairs)")


def davis_to_ytvos(davis_root: str, output: str) -> None:
    root = Path(davis_root)
    out = Path(output)
    for split, set_name in (("train", "train"), ("valid", "val")):
        split_file = root / "ImageSets" / "2017" / f"{set_name}.txt"
        if not split_file.exists():
            continue
        videos = [line.strip() for line in open(split_file) if line.strip()]
        (out / split).mkdir(parents=True, exist_ok=True)
        for sub in ("JPEGImages", "Annotations"):
            src_base = root / sub / "480p" if (root / sub / "480p").exists() else root / sub
            for v in videos:
                dst = out / split / sub / v
                if not dst.exists() and (src_base / v).exists():
                    dst.parent.mkdir(parents=True, exist_ok=True)
                    shutil.copytree(src_base / v, dst)
        # the release's expressions file of the split, or an empty one
        meta = {"videos": {}}
        davis_meta = root / "meta_expressions" / split / "meta_expressions.json"
        if davis_meta.exists():
            with open(davis_meta) as f:
                meta = json.load(f)
        out_meta = out / "meta_expressions" / split
        out_meta.mkdir(parents=True, exist_ok=True)
        with open(out_meta / "meta_expressions.json", "w") as f:
            json.dump(meta, f)
        print(f"{split}: {len(videos)} videos")


def convert_checkpoint(source: str, output: str, backbone: str = "resnet101",
                       enc_layers: int = 4, dec_layers: int = 4,
                       num_feature_levels: int = 4, text_layers: int = 12,
                       config_overrides: Optional[str] = None,
                       device: str = "cuda") -> None:
    """A reference ``.pth`` -> a port checkpoint directory at step 0.

    The checkpoint goes through ``load_pretrained_torch`` (class heads
    kept) into a model built for ``backbone`` and the layer counts; every
    tensor of that model must come from the checkpoint, else it raises
    (a wrong ``--backbone`` or layer count would otherwise save seeded
    weights under the checkpoint's name).
    """
    from ..config import OCPGConfig, apply_config_overrides
    from ..engine.checkpoint import CheckpointManager, load_pretrained_torch
    from ..models.build import build_model

    cfg = OCPGConfig(backbone=backbone, enc_layers=enc_layers, dec_layers=dec_layers,
                     num_feature_levels=num_feature_levels, text_layers=text_layers)
    cfg = apply_config_overrides(cfg, config_overrides)
    model = build_model(cfg, device)
    loaded = load_pretrained_torch(model, source, cfg, drop_class_heads=False)
    missing = sorted(set(model.state_dict()) - set(loaded))
    if missing:
        raise ValueError(f"{source}: {len(missing)} tensors of the {backbone} model are not "
                         f"in the checkpoint at their shape: {missing[:10]}")
    manager = CheckpointManager(output, max_to_keep=1)
    manager.save(0, {"model": model})
    manager.wait()
    print(f"converted {source} -> {output} ({len(loaded)} tensors)")


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser("ocpg_tpu_torch.cli.tools",
                                description="Data and checkpoint tools (the PyTorch "
                                            "port of ocpg_tpu.cli.tools).")
    sub = p.add_subparsers(dest="cmd", required=True)
    p1 = sub.add_parser("refexp2coco")
    p1.add_argument("--refer_root", required=True)
    p1.add_argument("--dataset", default="refcoco",
                    choices=["refcoco", "refcoco+", "refcocog"])
    p1.add_argument("--split_by", default="unc")
    p1.add_argument("--output", required=True)
    p2 = sub.add_parser("davis2ytvos")
    p2.add_argument("--davis_root", required=True)
    p2.add_argument("--output", required=True)
    p3 = sub.add_parser("convert_checkpoint")
    p3.add_argument("--source", required=True, help="reference OCPG .pth")
    p3.add_argument("--output", required=True, help="port checkpoint directory")
    p3.add_argument("--backbone", default="resnet101")
    p3.add_argument("--enc_layers", type=int, default=4)
    p3.add_argument("--dec_layers", type=int, default=4)
    p3.add_argument("--num_feature_levels", type=int, default=4)
    p3.add_argument("--text_layers", type=int, default=12)
    p3.add_argument("--config_overrides", default=None,
                    help="JSON dict of OCPGConfig field overrides (tests/tools)")
    p3.add_argument("--device", default="cuda",
                    help="torch device of the model the checkpoint loads into "
                         "(cpu for the tests)")
    args = p.parse_args(argv)
    if args.cmd == "refexp2coco":
        refexp_to_coco(args.refer_root, args.dataset, args.split_by, args.output)
    elif args.cmd == "convert_checkpoint":
        convert_checkpoint(args.source, args.output, args.backbone, args.enc_layers,
                           args.dec_layers, args.num_feature_levels, args.text_layers,
                           args.config_overrides, args.device)
    else:
        davis_to_ytvos(args.davis_root, args.output)


if __name__ == "__main__":
    main()
