"""RefCOCO/+/g pretraining entry point: counterpart of
``ocpg_tpu/cli/pretrain.py``, one process on one GPU.

The skeleton of ``cli/train.py`` on image clips (T = 1 by default, or
pseudo-video clips with ``--as_sequence``) of the referring-expression
datasets with full supervision, and after each epoch the referring-
detection eval of every dataset that has a val JSON
(``engine/evaluate.evaluate_refexp_loop``).  The eval model is built with
``dataset_file="refcoco"``, which selects the refine-every-query branch,
and takes the trained model's weights (its state dict) before each eval.
Outputs in ``--output_dir``: ``log.txt`` (one JSON line per epoch, the
val metrics as ``<dataset>_<metric>``), ``checkpoints/`` and ``tb/``.

Usage:
    python -m ocpg_tpu_torch.cli.pretrain --dataset_file refcoco \\
        --coco_path /data/coco --output_dir output/pretrain

``--device cpu`` runs on the CPU (the tests do); without a GPU the default
device raises.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Optional, Sequence


def get_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        "ocpg_tpu_torch.cli.pretrain",
        description="RefCOCO pretraining on one GPU (the PyTorch port of "
                    "ocpg_tpu.cli.pretrain).")
    p.add_argument("--dataset_file", default="refcoco",
                   choices=["refcoco", "refcoco+", "refcocog", "all"])
    p.add_argument("--backbone", default="resnet101")
    p.add_argument("--coco_path", required=True)
    p.add_argument("--refexp_ann_dir", default=None,
                   help="dir of COCO-format referring JSONs (default: --coco_path)")
    p.add_argument("--as_sequence", action="store_true",
                   help="augment images into pseudo-video clips")
    p.add_argument("--num_frames", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--output_dir", default="output/pretrain")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--tokenizer_path", default=None,
                   help="a RoBERTa tokenizer directory; default: the hash tokenizer")
    p.add_argument("--no_eval", action="store_true",
                   help="skip the per-epoch refcoco val evaluation")
    p.add_argument("--eval_batch_size", type=int, default=2)
    p.add_argument("--canvas", type=int, nargs=2, default=None, metavar=("H", "W"),
                   help="static loader canvas (default: canvas_for())")
    p.add_argument("--config_overrides", default=None,
                   help="JSON dict of OCPGConfig field overrides (tests/tools)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cpu for the tests)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = get_args(argv)

    from ..config import OCPGConfig, apply_config_overrides
    from ..data.loader import ClipLoader
    from ..data.refexp import ConcatClipDataset, RefExpDataset
    from ..engine.checkpoint import CheckpointManager
    from ..engine.evaluate import evaluate_refexp_loop
    from ..engine.optim import build_optimizer
    from ..engine.train import TrainStep
    from ..models.build import (build_model, build_weight_dict, criterion_config,
                                resolve_device)
    from ..models.text_encoder import SimpleTokenizer
    from ..parallel import prefetch_to_mesh
    from ..utils.logging import JSONLLogger, MetricMeter, TensorBoardLogger
    from ..utils.profiling import StepTimer

    device = resolve_device(args.device)
    cfg = OCPGConfig(backbone=args.backbone, dataset_file=args.dataset_file,
                     supervision="full", num_frames=args.num_frames, lr=args.lr,
                     batch_size=args.batch_size, epochs=args.epochs, seed=args.seed)
    cfg = apply_config_overrides(cfg, args.config_overrides)

    img_dir = Path(args.coco_path) / "train2014"
    ann_dir = Path(args.refexp_ann_dir or args.coco_path)
    names = (["refcoco", "refcoco+", "refcocog"] if args.dataset_file == "all"
             else [args.dataset_file])
    datasets = [RefExpDataset(str(img_dir), str(ann_dir / f"instances_{n}_train.json"),
                              num_frames=args.num_frames, as_sequence=args.as_sequence)
                for n in names]
    dataset = datasets[0] if len(datasets) == 1 else ConcatClipDataset(datasets)
    # per-dataset val sets, as the reference's main_pretrain.py
    val_sets = []
    if not args.no_eval:
        for n in names:
            val_ann = ann_dir / f"instances_{n}_val.json"
            if val_ann.exists():
                val_sets.append((n, RefExpDataset(str(img_dir), str(val_ann), num_frames=1)))

    tokenizer = SimpleTokenizer(args.tokenizer_path, vocab_size=cfg.text_vocab)
    canvas = tuple(args.canvas) if args.canvas else None
    loader = ClipLoader(dataset, cfg.batch_size, tokenizer=tokenizer, train=True,
                        seed=cfg.seed, canvas=canvas, compact=True)

    model = build_model(cfg, device)
    # one device: the JAX CLI's batch scaling by device_count is 1
    steps_per_epoch = max(len(dataset) // cfg.batch_size, 1)
    optimizer = build_optimizer(model, cfg, [e * steps_per_epoch for e in cfg.lr_drop])
    train_step = TrainStep(model, criterion_config(cfg), build_weight_dict(cfg), optimizer)
    state = {"model": model, "optimizer": optimizer, "train_step": train_step}

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    ckpt = CheckpointManager(str(out_dir / "checkpoints"))
    logger = JSONLLogger(out_dir / "log.txt")
    tb = TensorBoardLogger(out_dir / "tb")
    eval_model = build_model(cfg.replace(dataset_file="refcoco"), device) if val_sets else None
    for epoch in range(cfg.epochs):
        meter = MetricMeter()
        timer = StepTimer()
        t0 = time.time()
        for i, (_, on_device) in enumerate(prefetch_to_mesh(loader.epoch(epoch), device)):
            timer.data_ready()
            metrics = train_step(on_device)
            timer.step_done()
            if i % 50 == 0:
                vals = {"loss": metrics["loss"]}
                meter.update(vals)
                tb.scalars(train_step.state["step"], vals)
                print(f"epoch {epoch} it {i}/{steps_per_epoch} loss={vals['loss']:.4f}",
                      flush=True)
        ckpt.save(train_step.state["step"], state)
        record = {"epoch": epoch, "time_s": time.time() - t0,
                  **timer.averages(), **meter.averages()}
        if eval_model is not None:
            eval_model.load_state_dict(model.state_dict())
        for n, val_ds in val_sets:
            val_loader = ClipLoader(val_ds, args.eval_batch_size, tokenizer=tokenizer,
                                    train=False, seed=cfg.seed, canvas=canvas, compact=True)
            stats = evaluate_refexp_loop(eval_model, val_loader, device=device)
            record.update({f"{n}_{k}": v for k, v in stats.items()})
            tb.scalars(train_step.state["step"], {f"{n}/{k}": v for k, v in stats.items()})
            print(f"epoch {epoch} [{n}] " +
                  " ".join(f"{k}={v:.4f}" for k, v in stats.items()), flush=True)
        logger.write(record)
    ckpt.wait()  # the last epoch's save is written before exit
    tb.close()


if __name__ == "__main__":
    main()
