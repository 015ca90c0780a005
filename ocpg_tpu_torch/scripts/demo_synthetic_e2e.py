"""The whole product on one GPU: infer -> J&F, train, infer -> J&F, on a
synthetic Ref-DAVIS tree.  The port of ``scripts/demo_synthetic_e2e.py``.

It drives the port's production pipeline on a seeded Ref-DAVIS tree of two
language-distinguished moving boxes: ``cli.infer_davis`` with random
weights (ClipInferenceEngine, the annotator merge, palette PNGs) and
``evaluation.davis_eval`` (J&F), then ``cli.train`` (ClipLoader, TrainStep,
checkpoints), then ``cli.infer_davis`` from the trained checkpoint
directory and J&F again.  Training should move J&F far above the
random-weight baseline.

Usage:
    python -m ocpg_tpu_torch.scripts.demo_synthetic_e2e [--epochs 12]
        [--workdir DIR] [--dtype bfloat16] [--out output/E2E_SYNTH_GPU.json]

It writes a JSON record {jf_random, jf_trained, steps, train: {loss_first,
loss_last, ...}, platform, devices, ...}, where ``platform`` is the card's
name and power limit as nvidia-smi gives them and ``devices`` the number of
GPUs, and prints one summary line.  ``--device cpu`` runs on the CPU (the
tests do, with ``--epochs 1`` and one video per split); without a GPU the
default device raises.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

H, W = 128, 160
N_FRAMES = 8

# one model for all phases: small enough to train in minutes from random
# init, big enough to bind "red"/"blue" to the right object through the
# vision-language fusion.  The level-set warmup is short (production 100k):
# with binary full-supervision heatmaps the masked-CE confidence weight is
# zero inside the box (models/criterion.py::masked_ce_loss), so the mask
# interior is learned by the level-set phase after the warmup.
DEMO_CFG = {
    "enc_layers": 2, "dec_layers": 2, "dim_feedforward": 512,
    "num_queries": 5,
    "text_layers": 2, "text_hidden": 128, "text_heads": 4, "text_ffn": 256,
    "text_vocab": 2048,
    "lst_warmup_iters": 200,
}

# 4 annotator phrasings per object (valid-split convention:
# exp index = obj_id * 4 + anno_id)
PHRASINGS = {
    "red": ["the red box", "red box", "the red square", "a red box"],
    "blue": ["the blue box", "blue box", "the blue square", "a blue box"],
}

RED, BLUE = (236, 95, 103), (87, 145, 249)


def _video_masks(rng: np.random.Generator) -> np.ndarray:
    """(T, H, W) uint8 label maps: two moving boxes with random trajectories."""
    out = np.zeros((N_FRAMES, H, W), np.uint8)
    bh, bw = 36, 28
    # keep starting corners apart so the objects never fully overlap
    y1, x1 = rng.integers(4, H - bh - 20), rng.integers(4, W // 2 - bw)
    y2, x2 = rng.integers(4, H - bh - 20), rng.integers(W // 2, W - bw - 20)
    v1 = rng.integers(-2, 3, size=2)
    v2 = rng.integers(-2, 3, size=2)
    for t in range(N_FRAMES):
        a = (int(np.clip(y1 + v1[0] * t, 0, H - bh)),
             int(np.clip(x1 + v1[1] * t, 0, W - bw)))
        b = (int(np.clip(y2 + v2[0] * t, 0, H - bh)),
             int(np.clip(x2 + v2[1] * t, 0, W - bw)))
        out[t, a[0]:a[0] + bh, a[1]:a[1] + bw] = 1     # red object
        out[t, b[0]:b[0] + bh, b[1]:b[1] + bw] = 2     # blue object
    return out


def build_tree(root: Path, n_train: int, n_valid: int, seed: int = 0) -> None:
    """The seeded Ref-DAVIS tree: JPEG frames, palette-PNG annotations (the
    valid split's also at the root, where the scorer reads them), the
    expression files and ImageSets/2017/val.txt."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    palette = [0, 0, 0, *RED, *BLUE] + [0] * (256 * 3 - 9)

    def write_split(split, videos, meta_exps):
        meta = {"videos": {}}
        for video in videos:
            gt = _video_masks(rng)
            (root / split / "JPEGImages" / video).mkdir(parents=True)
            (root / split / "Annotations" / video).mkdir(parents=True)
            frames = [f"{i:05d}" for i in range(N_FRAMES)]
            base = rng.integers(30, 70, size=(H, W, 3)).astype(np.uint8)
            for t, name in enumerate(frames):
                rgb = base.copy()
                rgb[gt[t] == 1] = RED
                rgb[gt[t] == 2] = BLUE
                Image.fromarray(rgb).save(
                    root / split / "JPEGImages" / video / f"{name}.jpg", quality=95)
                pimg = Image.fromarray(gt[t])
                pimg.putpalette(palette)          # an "L" image becomes "P"
                pimg.save(root / split / "Annotations" / video / f"{name}.png")
                if split == "valid":
                    (root / "Annotations" / video).mkdir(parents=True, exist_ok=True)
                    pimg.save(root / "Annotations" / video / f"{name}.png")
            meta["videos"][video] = {"frames": frames, "expressions": meta_exps}
        (root / "meta_expressions" / split).mkdir(parents=True)
        with open(root / "meta_expressions" / split / "meta_expressions.json", "w") as f:
            json.dump(meta, f)
        return list(meta["videos"])

    # train split: one expression per object (the DAVIS reader needs obj_id)
    write_split("train", [f"tr{v}" for v in range(n_train)], {
        "0": {"exp": PHRASINGS["red"][0], "obj_id": "1"},
        "1": {"exp": PHRASINGS["blue"][0], "obj_id": "2"},
    })
    # valid split: 4 annotator phrasings per object, exp i = obj * 4 + anno
    valid_videos = [f"va{v}" for v in range(n_valid)]
    write_split("valid", valid_videos, {
        str(i): {"exp": (PHRASINGS["red"] + PHRASINGS["blue"])[i]} for i in range(8)
    })
    (root / "ImageSets" / "2017").mkdir(parents=True)
    with open(root / "ImageSets" / "2017" / "val.txt", "w") as f:
        f.write("\n".join(valid_videos) + "\n")


def run_train(root: Path, out_dir: Path, args) -> dict:
    """``cli.train`` on the tree's train split; the first and last epoch's
    mean logged loss from its log.txt."""
    from ..cli import train as train_cli

    t0 = time.time()
    train_cli.main([
        "--dataset_file", "davis", "--davis_path", str(root),
        "--supervision", "full", "--backbone", args.backbone,
        "--num_frames", "2", "--batch_size", "1",
        "--epochs", str(args.epochs), "--num_workers", str(args.workers),
        "--lr", "5e-4", "--lr_backbone", "5e-4",
        "--output_dir", str(out_dir), "--canvas", str(H), str(W),
        "--log_every", "100", "--tb_every", "0",
        "--compute_dtype", args.dtype, "--seed", "7",
        "--config_overrides", json.dumps(DEMO_CFG), "--device", args.device,
    ])
    wall = time.time() - t0
    with open(out_dir / "log.txt") as f:
        epochs = [json.loads(line) for line in f if line.strip()]
    return {"train_wall_s": round(wall, 1),
            "loss_first": round(epochs[0]["loss"], 3),
            "loss_last": round(epochs[-1]["loss"], 3),
            "epochs": len(epochs)}


def run_infer(root: Path, out_dir: Path, ckpt, args) -> None:
    """``cli.infer_davis`` on the valid split: random weights, or the
    train run's ``checkpoints`` directory."""
    from ..cli import infer_davis

    argv = [
        "--davis_path", str(root), "--output_dir", str(out_dir),
        "--backbone", args.backbone, "--split", "valid", "--clip_len", str(N_FRAMES),
        "--resize", str(H), "--max_size", str(W),
        "--config_overrides", json.dumps({**DEMO_CFG, "compute_dtype": args.dtype}),
        "--device", args.device,
    ]
    if ckpt:
        argv += ["--checkpoint", str(ckpt)]
    infer_davis.main(argv)


def score(root: Path, out_dir: Path) -> dict:
    """J&F-Mean of each annotator's result PNGs against the tree's root
    Annotations, and their mean."""
    from ..evaluation.davis_eval import evaluate_davis, global_summary

    jf = []
    for anno_id in range(4):
        results = out_dir / "valid" / f"anno_{anno_id}"
        metrics = evaluate_davis(str(root), str(results), "val")
        jf.append(global_summary(metrics)["J&F-Mean"])
    return {"jf_mean": round(float(np.mean(jf)), 4),
            "jf_per_annotator": [round(float(v), 4) for v in jf]}


def get_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("ocpg_tpu_torch.scripts.demo_synthetic_e2e",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--epochs", type=int, default=12,
                   help="128 steps/epoch at the default tree size")
    p.add_argument("--train_videos", type=int, default=8)
    p.add_argument("--valid_videos", type=int, default=2)
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--workdir", default=None,
                   help="keep the tree, checkpoints and PNGs here "
                        "(default: a temporary directory, deleted on success)")
    p.add_argument("--out", default="output/E2E_SYNTH_GPU.json")
    p.add_argument("--device", default="cuda", help="torch device (cpu for the tests)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the three phases; returns the record it writes to ``--out``."""
    from ..models.build import resolve_device
    from ..utils.hw import device_record

    args = get_args(argv)
    resolve_device(args.device)
    work = Path(args.workdir) if args.workdir else Path(tempfile.mkdtemp(prefix="ocpg_demo_"))
    work.mkdir(parents=True, exist_ok=True)
    tree = work / "davis"
    if not (tree / "meta_expressions").exists():
        build_tree(tree, args.train_videos, args.valid_videos)

    record = {**device_record(args.device),
              "config": DEMO_CFG, "dtype": args.dtype, "epochs": args.epochs,
              "steps": args.epochs * args.train_videos * 2 * N_FRAMES}

    print("== phase 1: random-weight baseline infer -> eval ==", flush=True)
    run_infer(tree, work / "out_random", None, args)
    record["random"] = score(tree, work / "out_random")

    print("== phase 2: train ==", flush=True)
    record["train"] = run_train(tree, work / "train", args)

    print("== phase 3: trained infer -> eval ==", flush=True)
    run_infer(tree, work / "out_trained", work / "train" / "checkpoints", args)
    record["trained"] = score(tree, work / "out_trained")

    record["jf_random"] = record["random"]["jf_mean"]
    record["jf_trained"] = record["trained"]["jf_mean"]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({k: record[k] for k in ("platform", "steps", "jf_random", "jf_trained")}))
    if not args.workdir:
        shutil.rmtree(work, ignore_errors=True)
    return record


if __name__ == "__main__":
    main()
