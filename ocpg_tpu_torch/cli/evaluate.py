"""A2D / JHMDB evaluation entry point: counterpart of
``ocpg_tpu/cli/evaluate.py``, one process on one GPU.

The val split in the compact wire through ``ClipLoader`` (a padded tail
batch keeps every sample scored), ``engine/evaluate.evaluate_a2d``, and the
metrics printed as one JSON object.

Usage:
    python -m ocpg_tpu_torch.cli.evaluate --dataset_file a2d --a2d_path /data/a2d \\
        --checkpoint output/a2d_r101/checkpoints --backbone resnet101

``--checkpoint`` takes a port checkpoint directory (``cli/train.py``'s
``checkpoints/``) or a reference ``.pth`` file; without it the weights are
the model's seeded init.
``--device cpu`` runs on the CPU (the tests do); without a GPU the default
device raises.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence


def get_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        "ocpg_tpu_torch.cli.evaluate",
        description="A2D/JHMDB evaluation on one GPU (the PyTorch port of "
                    "ocpg_tpu.cli.evaluate).")
    p.add_argument("--dataset_file", default="a2d", choices=["a2d", "jhmdb"])
    p.add_argument("--backbone", default="resnet101")
    p.add_argument("--a2d_path", default=None)
    p.add_argument("--jhmdb_path", default=None)
    p.add_argument("--checkpoint", default=None,
                   help="a port checkpoints/ directory or a reference .pth file")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--num_frames", type=int, default=3)
    p.add_argument("--tokenizer_path", default=None,
                   help="a RoBERTa tokenizer directory; default: the hash tokenizer")
    p.add_argument("--invert_masks", action="store_true",
                   help="the reference postprocessor's mask inversion quirk")
    p.add_argument("--readback", default="f32", choices=["f16", "f32"],
                   help="mask-logit readback of --postprocess host: f32 (default) "
                        "or f16, half the bytes")
    p.add_argument("--postprocess", default="device", choices=["device", "host"],
                   help="'device' (default): crop, resize to the original size, "
                        "threshold and bit-pack on the device, so packed binary masks "
                        "at native resolution come back; 'host': the full-canvas "
                        "logits come back for the numpy postprocess")
    p.add_argument("--canvas", type=int, nargs=2, default=None, metavar=("H", "W"),
                   help="static loader canvas (default: canvas_for())")
    p.add_argument("--config_overrides", default=None,
                   help="JSON dict of OCPGConfig field overrides (tests/tools)")
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (cpu for the tests)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    args = get_args(argv)

    from ..config import OCPGConfig, apply_config_overrides
    from ..data.datasets import build_dataset
    from ..data.loader import ClipLoader
    from ..engine.checkpoint import load_checkpoint
    from ..engine.evaluate import evaluate_a2d
    from ..models.build import build_model, resolve_device
    from ..models.text_encoder import SimpleTokenizer

    device = resolve_device(args.device)
    cfg = OCPGConfig(backbone=args.backbone, dataset_file=args.dataset_file,
                     num_frames=args.num_frames)
    cfg = apply_config_overrides(cfg, args.config_overrides)
    root = args.a2d_path if args.dataset_file == "a2d" else args.jhmdb_path
    dataset = build_dataset(args.dataset_file, root, "val", cfg.num_frames)
    loader = ClipLoader(dataset, args.batch_size,
                        tokenizer=SimpleTokenizer(args.tokenizer_path,
                                                  vocab_size=cfg.text_vocab),
                        train=False,
                        canvas=tuple(args.canvas) if args.canvas else None,
                        compact=True)
    model = build_model(cfg, device)
    if args.checkpoint:
        load_checkpoint(model, args.checkpoint, cfg)
    metrics = evaluate_a2d(model, loader, invert_masks=args.invert_masks,
                           readback=args.readback, postprocess=args.postprocess,
                           device=device)
    print(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    main()
