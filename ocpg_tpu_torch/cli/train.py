"""Training entry point: counterpart of ``ocpg_tpu/cli/train.py``, one
process on one GPU.

The per-epoch flow of the reference's ``main.py``: the dataset from the
flags, ``ClipLoader`` in the compact wire, the batches copied to the device
one ahead (``prefetch_to_mesh``), ``TrainStep`` per batch, a checkpoint and
one ``log.txt`` line per epoch.  Outputs in ``--output_dir``: ``configs``
(the config), ``log.txt`` (JSON lines), ``checkpoints/``, ``debug_images/``
(``--debug_images_every``), ``tb/`` (``--tb_every``, with the tensorboard
package) and ``--profile_dir``'s trace of steps 10-14.

Usage:
    python -m ocpg_tpu_torch.cli.train --dataset_file ytvos --backbone resnet101 \\
        --ytvos_path /data/ytvos --output_dir output/ytvos_r101 --supervision box

``--device cpu`` runs on the CPU (the tests do); without a GPU the default
device raises.
"""

from __future__ import annotations

import argparse
import contextlib
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np


def get_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        "ocpg_tpu_torch.cli.train",
        description="Train OCPG on one GPU (the PyTorch port of ocpg_tpu.cli.train).",
        epilog="The JAX CLI's --msda_impl and --prng_impl select JAX machinery "
               "and are not flags here: the port's OCPGConfig has no msda_impl, "
               "swin_attn_impl, data_parallel or prng_impl field, so "
               "--config_overrides naming one of them raises, as an unknown "
               "key does.")
    p.add_argument("--dataset_file", default="ytvos",
                   choices=["ytvos", "a2d", "davis",
                            "joint", "joint_coco", "ytvos_joint_davis"])
    p.add_argument("--backbone", default="resnet101")
    p.add_argument("--supervision", default="box", choices=["full", "box", "point"])
    p.add_argument("--supervision_type", default="boxsup",
                   choices=["boxsup", "boxinst", "boxlevelset", "boxvos", "partialsup"],
                   help="loss-suite variant: boxinst and boxvos add the BoxInst "
                        "pairwise color-similarity losses (models/pairwise.py); "
                        "the others keep the default suite")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--num_frames", type=int, default=3)
    p.add_argument("--output_dir", default="output")
    p.add_argument("--ytvos_path", default=None)
    p.add_argument("--a2d_path", default=None)
    p.add_argument("--davis_path", default=None)
    p.add_argument("--coco_path", default=None,
                   help="COCO root for the joint refcoco-seq datasets")
    p.add_argument("--refexp_ann_dir", default=None,
                   help="dir of COCO-format referring JSONs for joint training")
    p.add_argument("--pretrained_weights", default=None,
                   help="a reference OCPG .pth (or a converted tree) to finetune "
                        "from; the class heads keep their init")
    p.add_argument("--resume", default=None, help="a checkpoints/ directory")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--tokenizer_path", default=None,
                   help="a RoBERTa tokenizer directory; default: the hash tokenizer")
    p.add_argument("--num_workers", type=int, default=None,
                   help="loader decode threads; default = min(4, host cores)")
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler Chrome trace of steps 10-14")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cpu for the tests)")
    # model / recipe flags (the reference's opts.py)
    p.add_argument("--dilation", action="store_true", help="DC5 backbone")
    p.add_argument("--unfreeze_text_encoder", action="store_true",
                   help="train the text encoder (reference default freezes it)")
    p.add_argument("--freeze_video_encoder", action="store_true")
    p.add_argument("--use_checkpoint", action="store_true",
                   help="recompute each Swin block in the backward")
    p.add_argument("--lr_backbone", type=float, default=None)
    p.add_argument("--lr_text_encoder", type=float, default=None)
    p.add_argument("--lr_linear_proj_mult", type=float, default=None)
    p.add_argument("--lr_drop", type=int, nargs="+", default=None)
    p.add_argument("--weight_decay", type=float, default=None)
    p.add_argument("--clip_max_norm", type=float, default=None)
    p.add_argument("--num_feature_levels", type=int, default=None)
    p.add_argument("--num_queries", type=int, default=None)
    p.add_argument("--enc_layers", type=int, default=None)
    p.add_argument("--dec_layers", type=int, default=None)
    p.add_argument("--compute_dtype", default=None, choices=["bfloat16", "float32"])
    # observability (the reference's util/logger.py and engine.py)
    p.add_argument("--tb_every", type=int, default=200)
    p.add_argument("--debug_images_every", type=int, default=0,
                   help=">0: dump pred/target/weak map PNGs every N iters (needs cv2)")
    p.add_argument("--canvas", type=int, nargs=2, default=None, metavar=("H", "W"),
                   help="static loader canvas (default: canvas_for())")
    p.add_argument("--config_overrides", default=None,
                   help="JSON dict of OCPGConfig field overrides (tests/tools)")
    return p.parse_args(argv)


def make_config(args: argparse.Namespace):
    from ..config import OCPGConfig, apply_config_overrides

    cfg = OCPGConfig(
        backbone=args.backbone, dataset_file=args.dataset_file,
        supervision=args.supervision, num_frames=args.num_frames,
        lr=args.lr, batch_size=args.batch_size, seed=args.seed,
        dilation=args.dilation,
        freeze_text_encoder=not args.unfreeze_text_encoder,
        freeze_video_encoder=args.freeze_video_encoder,
        use_checkpoint=args.use_checkpoint,
        pairwise_loss=args.supervision_type in ("boxinst", "boxvos"),
    )
    if args.epochs:
        cfg = cfg.replace(epochs=args.epochs)
    for flag in ("lr_backbone", "lr_text_encoder", "lr_linear_proj_mult",
                 "weight_decay", "clip_max_norm", "num_feature_levels",
                 "num_queries", "enc_layers", "dec_layers", "compute_dtype"):
        v = getattr(args, flag)
        if v is not None:
            cfg = cfg.replace(**{flag: v})
    if args.lr_drop is not None:
        cfg = cfg.replace(lr_drop=tuple(args.lr_drop))
    return apply_config_overrides(cfg, args.config_overrides)


def make_dataset(args: argparse.Namespace, cfg):
    from ..data.datasets import build_dataset

    root = {"ytvos": args.ytvos_path, "a2d": args.a2d_path, "davis": args.davis_path,
            "joint": args.ytvos_path, "joint_coco": args.coco_path,
            "ytvos_joint_davis": args.ytvos_path}[args.dataset_file]
    return build_dataset(args.dataset_file, root, "train", cfg.num_frames,
                         cfg.supervision, coco_path=args.coco_path,
                         coco_ann_dir=args.refexp_ann_dir, davis_path=args.davis_path)


def make_loader(args: argparse.Namespace, cfg, dataset):
    """The train loader in the compact wire (uint8 frames and masks, f16
    heatmaps; normalised on the device by the step)."""
    from ..data.loader import ClipLoader
    from ..models.text_encoder import SimpleTokenizer

    return ClipLoader(dataset, cfg.batch_size,
                      tokenizer=SimpleTokenizer(args.tokenizer_path,
                                                vocab_size=cfg.text_vocab),
                      train=True, seed=cfg.seed,
                      canvas=tuple(args.canvas) if args.canvas else None,
                      num_workers=args.num_workers, compact=True)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = get_args(argv)

    from ..data.imageio import decoder
    from ..engine.checkpoint import CheckpointManager, load_pretrained_torch
    from ..engine.optim import build_optimizer
    from ..engine.train import TrainStep
    from ..models.build import (build_model, build_weight_dict, criterion_config,
                                resolve_device)
    from ..parallel import prefetch_to_mesh
    from ..utils.logging import JSONLLogger, MetricMeter, TensorBoardLogger
    from ..utils.profiling import StepTimer, trace

    device = resolve_device(args.device)
    cfg = make_config(args)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "configs").write_text(str(cfg))

    dataset = make_dataset(args, cfg)
    loader = make_loader(args, cfg, dataset)
    print(f"data: {len(dataset)} clips, decode {decoder()}, "
          f"{loader.num_workers} loader threads, canvas {loader.canvas}", flush=True)

    model = build_model(cfg, device)
    if args.pretrained_weights:
        load_pretrained_torch(model, args.pretrained_weights, cfg)
    # one device: the JAX CLI's linear LR scale max(devices / 4, 1) is 1
    steps_per_epoch = max(len(dataset) // cfg.batch_size, 1)
    optimizer = build_optimizer(model, cfg, [e * steps_per_epoch for e in cfg.lr_drop])
    # of the train datasets only A2D's clips carry valid_indices
    train_step = TrainStep(model, criterion_config(cfg), build_weight_dict(cfg), optimizer,
                           has_valid_indices=cfg.dataset_file == "a2d",
                           debug_images=args.debug_images_every > 0)
    state = {"model": model, "optimizer": optimizer, "train_step": train_step}

    ckpt = CheckpointManager(str(out_dir / "checkpoints"))
    start_epoch = 0
    if args.resume:
        restored = CheckpointManager(args.resume).restore()
        for name, obj in state.items():
            obj.load_state_dict(restored[name])
        start_epoch = train_step.state["step"] // steps_per_epoch

    logger = JSONLLogger(out_dir / "log.txt")
    tb = TensorBoardLogger(out_dir / "tb" if args.tb_every else None)
    debug_dir = out_dir / "debug_images"

    def dump_debug_images(step_no, pred, batch):
        """pred/target/weak map PNGs (the reference's engine.py)."""
        import cv2

        debug_dir.mkdir(parents=True, exist_ok=True)
        tgt = np.asarray(batch["targets"]["masks"])[0, 0]
        weak = np.asarray(batch["targets"]["weak_masks"])[0, 0]
        for name, m in (("pred", np.asarray(pred)), ("target", tgt), ("weak", weak)):
            cv2.imwrite(str(debug_dir / f"{step_no:07d}_{name}.png"),
                        (np.clip(m, 0, 1) * 255).astype(np.uint8))

    step_no = train_step.state["step"]
    profiling = contextlib.ExitStack()
    for epoch in range(start_epoch, cfg.epochs):
        meter = MetricMeter()
        timer = StepTimer()
        t0 = time.time()
        for i, (batch, on_device) in enumerate(
                prefetch_to_mesh(loader.epoch(epoch), device)):
            timer.data_ready()
            if args.profile_dir and epoch == start_epoch and i == 10:
                profiling.enter_context(trace(args.profile_dir))
            metrics = train_step(on_device)
            if i == 14:
                profiling.close()
            # the step reads its losses back to the host, so it has finished
            timer.step_done()
            step_no += 1
            if i % args.log_every == 0:
                vals = {k: v for k, v in metrics.items()
                        if k in ("loss", "grad_norm", "loss_ce", "loss_mask",
                                 "loss_proj", "loss_lst", "loss_bbox", "loss_giou")}
                meter.update(vals)
                print(f"epoch {epoch} it {i}/{steps_per_epoch} " +
                      " ".join(f"{k}={v:.4f}" for k, v in vals.items()), flush=True)
            if args.tb_every and i % args.tb_every == 0:
                tb.scalars(step_no, {k: v for k, v in metrics.items() if np.ndim(v) == 0})
            if args.debug_images_every and i % args.debug_images_every == 0:
                dump_debug_images(step_no, metrics["debug_pred"], batch)
        profiling.close()
        ckpt.save(train_step.state["step"], state)
        logger.write({"epoch": epoch, "time_s": time.time() - t0,
                      **timer.averages(), **meter.averages()})
    ckpt.wait()  # the last epoch's save is written before exit
    tb.close()
    print("done")


if __name__ == "__main__":
    main()
