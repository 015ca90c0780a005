"""A long loader-fed training run on one GPU with a mid-run checkpoint, a
resume replay and a validation J/F curve.  The port of
``scripts/train_long_run.py``.

The full-width ``ytvos_r101_boxsup`` model (ResNet-101, RoBERTa-base, 4+4
layers, bf16; B=1, T=3, canvas 512 x 640) trains for ``--steps`` steps on
batches from ``ClipLoader(compact=True)`` over a seeded tree on disk
(``--videos`` videos of ``--frames_per_video`` 720 x 1280 JPEG frames, one
expression each, the object a fixed box in the frame centre):

* at ``--ckpt_step`` a checkpoint of the model, the optimizer and the step
  (counter and dropout generator) is saved, read back at once and held
  bit-identical to the live state, and the next ``--replay_steps`` batches
  are kept;
* at step 1 and every ``--eval_every`` steps the eval forward runs on two
  held-out batches (``synthetic_val_jf``: the model's eval mode under
  ``no_grad``, so it draws nothing from the dropout generator);
* after the run the checkpoint is restored into a fresh model, optimizer
  and step, held bit-identical to the file, and replayed over the kept
  batches, twice.  The MSDA backward and the scatter-add backwards add in
  float32 with atomics on the GPU, so the replay is not bit-exact there,
  and training amplifies those last-bit differences from step to step:
  two replays from one restored state part by about 1e-3 relative within
  10 steps on an H100.  The record gives ``resume_bit_exact`` as read,
  ``resume_max_rel_diff`` (replay against the live losses) beside
  ``replay_repeat_max_rel_diff`` (the second replay against the first, the
  run-to-run spread).  The run fails unless the first replayed loss equals
  the live one bit for bit (no backward has run since the restore) and the
  first two are within 1e-3 relative (one backward's atomics in between,
  as in chip_smoke.py's phase resume).

The tree is ``bench_loader.build_tree``'s, as in the JAX script:
``--dataset ytvos`` (the default) writes a Ref-YouTube-VOS tree with h5
heatmaps; ``--dataset davis`` a Ref-DAVIS tree of the same size, frames
and masks without them.  The record, written to ``--out``, says which ran.

Usage:
    python -m ocpg_tpu_torch.scripts.train_long_run [--steps 2000] [--dataset davis]

``--device cpu`` runs on the CPU; without a GPU the default device raises.
``run(LongRunConfig(...))`` takes a smaller model, tree and canvas (the
tests' way in).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import shutil
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import OCPGConfig, ytvos_r101_boxsup
from .bench_loader import build_tree

# the replayed steps held to REPLAY_RTOL of the live losses: the first two
# (after more steps the card's run-to-run spread alone passes the bound)
REPLAY_RTOL, REPLAY_HELD = 1e-3, 2


def default_model() -> OCPGConfig:
    return ytvos_r101_boxsup().replace(compute_dtype="bfloat16")


@dataclasses.dataclass
class LongRunConfig:
    steps: int = 2000
    ckpt_step: int = 1000
    replay_steps: int = 10
    eval_every: int = 500
    videos: int = 6
    frames_per_video: int = 16
    workers: int = 1
    dataset: str = "ytvos"
    device: str = "cuda"
    out: Optional[str] = "output/TRAIN_LONG_GPU.json"
    keep_params: Optional[str] = None
    model: OCPGConfig = dataclasses.field(default_factory=default_model)
    canvas: Tuple[int, int] = (512, 640)
    frame_size: Tuple[int, int] = (720, 1280)


# ------------------------------------------------------------------- val --
def synthetic_val_jf(model, batches) -> Tuple[float, float]:
    """Mean J (mask IoU) and boundary F of the eval forward's masks,
    ``sigmoid(pred_masks[:, :, 0]) > 0.5``, against the batches' GT masks
    (``evaluation/davis_metrics.py``).  The model runs in eval mode under
    ``no_grad`` (no dropout, so the train step's generator is not drawn
    from) and is put back in its mode after."""
    from ..data.loader import decompress_batch
    from ..engine.train import _to_device
    from ..evaluation.davis_metrics import db_eval_boundary, db_eval_iou

    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    js, fs = [], []
    try:
        with torch.no_grad():
            for raw in batches:
                b = decompress_batch(_to_device(raw, device))
                out = model(b["samples"], b["samples_mask"], b["text_ids"], b["text_mask"],
                            b["targets"]["size"], train=False)
                pred = (torch.sigmoid(out["pred_masks"][:, :, 0].float()) > 0.5).cpu().numpy()
                gt = (b["targets"]["masks"] > 0.5).cpu().numpy()
                for i in range(pred.shape[0]):
                    for t in range(pred.shape[1]):
                        js.append(float(db_eval_iou(gt[i, t], pred[i, t])))
                        fs.append(float(db_eval_boundary(gt[i, t], pred[i, t])))
    finally:
        model.train(was_training)
    return float(np.mean(js)), float(np.mean(fs))


# ---------------------------------------------------------------- resume --
def _bytes(t):
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)


def first_difference(got: Any, want: Any, path: str = "") -> Optional[str]:
    """The path of the first leaf where two state-dict trees differ (a
    tensor in dtype, shape or any bit; another leaf by ``==``; a key), or
    None when they are identical."""
    if isinstance(want, torch.Tensor):
        if not (isinstance(got, torch.Tensor) and got.dtype == want.dtype
                and got.shape == want.shape
                and torch.equal(_bytes(got), _bytes(want))):
            return path or "<root>"
        return None
    if isinstance(want, dict):
        if not isinstance(got, dict) or list(got) != list(want):
            return f"{path} (keys)"
        for k in want:
            diff = first_difference(got[k], want[k], f"{path}/{k}")
            if diff:
                return diff
        return None
    if isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            return f"{path} (length)"
        for i, (g, w) in enumerate(zip(got, want)):
            diff = first_difference(g, w, f"{path}/{i}")
            if diff:
                return diff
        return None
    return None if got == want else path


def state_dicts(state: Dict[str, Any]) -> Dict[str, Any]:
    return {name: obj.state_dict() for name, obj in state.items()}


def require_identical(label: str, got: Dict[str, Any], want: Dict[str, Any]) -> None:
    diff = first_difference(got, want)
    if diff:
        raise RuntimeError(f"{label}: the restored state differs from the saved one at {diff}")


def max_rel_diff(got: Sequence[float], want: Sequence[float]) -> float:
    return max((abs(g - w) / max(abs(w), 1e-6) for g, w in zip(got, want)), default=0.0)


# ------------------------------------------------------------------- run --
def run(config: LongRunConfig) -> Dict[str, Any]:
    """The run of the module docstring; returns the record (also written
    to ``config.out`` unless it is None)."""
    from ..data.datasets import build_dataset
    from ..data.loader import ClipLoader
    from ..engine.checkpoint import CheckpointManager
    from ..engine.optim import build_optimizer
    from ..engine.train import TrainStep
    from ..models.build import build_model, build_weight_dict, criterion_config, resolve_device
    from ..utils.hw import device_record

    device = resolve_device(config.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    cfg = config.model
    root = tempfile.mkdtemp(prefix="longrun_")
    ckpt_dir = tempfile.mkdtemp(prefix="longrun_ckpt_")
    try:
        t0 = time.time()
        build_tree(root, config.videos, config.frames_per_video, *config.frame_size,
                   dataset=config.dataset)
        print(f"fixture tree ({config.dataset}) built in {time.time() - t0:.1f}s", flush=True)

        dataset = build_dataset(config.dataset, root, "train", cfg.num_frames, "box")
        loader = ClipLoader(dataset, 1, canvas=tuple(config.canvas), train=True,
                            num_workers=config.workers, text_vocab=cfg.text_vocab,
                            compact=True)

        def fresh():
            model = build_model(cfg, device)
            optimizer = build_optimizer(model, cfg, [10 ** 9])
            step = TrainStep(model, criterion_config(cfg), build_weight_dict(cfg), optimizer)
            return {"model": model, "optimizer": optimizer, "train_step": step}

        state = fresh()
        model, train_step = state["model"], state["train_step"]
        n_params = sum(p.numel() for p in model.parameters())
        mgr = CheckpointManager(ckpt_dir)

        def batches():
            for e in itertools.count():
                yield from loader.epoch(e)

        it = batches()
        curve, curve_jf = [], []
        replay_batches, replay_live = [], []
        val_batches = [next(it) for _ in range(2)]      # fixed held-out batches

        t_run0 = time.time()
        saved_wall = None
        for step in range(config.steps):
            raw = next(it)
            metrics = train_step(raw)
            curve.append(metrics["loss"])
            if step + 1 == config.ckpt_step:
                t0 = time.time()
                mgr.save(step + 1, state)
                mgr.wait()
                saved_wall = time.time() - t0
                require_identical("checkpoint", mgr.restore(step + 1), state_dicts(state))
                print(f"checkpoint saved at step {step + 1} ({saved_wall:.1f}s), "
                      f"read back bit-identical", flush=True)
            if config.ckpt_step <= step < config.ckpt_step + config.replay_steps:
                # the batches right after the save, kept for the replay
                replay_batches.append(raw)
                replay_live.append(metrics["loss"])
            if (step + 1) % config.eval_every == 0 or step == 0:
                j, fb = synthetic_val_jf(model, val_batches)
                curve_jf.append({"step": step + 1, "J": round(j, 4), "F": round(fb, 4)})
                print(f"step {step + 1}: loss {curve[-1]:.3f} J {j:.3f} F {fb:.3f} "
                      f"({time.time() - t_run0:.0f}s)", flush=True)
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall_s = time.time() - t_run0
        peak_gib = (torch.cuda.max_memory_allocated(device) / 2 ** 30
                    if device.type == "cuda" else None)

        if config.keep_params:
            final_mgr = CheckpointManager(config.keep_params)
            final_mgr.save(config.steps, state)
            final_mgr.wait()
            print(f"final trained state saved to {config.keep_params}", flush=True)
        del state, model, train_step
        if device.type == "cuda":
            torch.cuda.empty_cache()

        # the resume: the checkpoint into fresh objects, replayed twice (read
        # anew each time: on the CPU the optimizer adopts the file's moment
        # tensors as they are, and its steps update them in place)
        replays = []
        for _ in range(2):
            saved = CheckpointManager(ckpt_dir).restore()
            if saved["train_step"]["step"] != config.ckpt_step:
                raise RuntimeError(f"restored step {saved['train_step']['step']} != "
                                   f"{config.ckpt_step}")
            resumed = fresh()
            for name, obj in resumed.items():
                obj.load_state_dict(saved[name])
            require_identical("resume", state_dicts(resumed), saved)
            replays.append([resumed["train_step"](raw)["loss"] for raw in replay_batches])
            del resumed, saved
        replay, repeat = replays
        bit_exact = replay == replay_live
        rel = max_rel_diff(replay, replay_live)
        spread = max_rel_diff(repeat, replay)
        print(f"resume: restored state bit-identical; replay bit-exact: {bit_exact}, "
              f"max rel diff {rel:.3e} (run-to-run {spread:.3e})", flush=True)

        canvas = "x".join(map(str, config.canvas))
        record = {
            **device_record(config.device),
            "dataset": config.dataset,
            "backbone": cfg.backbone,
            "params_m": round(n_params / 1e6, 1),
            "shape": f"1x{cfg.num_frames}f {canvas} {cfg.compute_dtype}, loader-fed "
                     f"(compact wire), {config.workers} worker",
            "tree": f"{config.videos} videos x {config.frames_per_video} frames at "
                    f"{config.frame_size[0]}x{config.frame_size[1]}",
            "steps": config.steps,
            "wall_s": round(wall_s, 1),
            "ms_per_step_e2e": round(wall_s / config.steps * 1000, 1),
            "peak_memory_gib": None if peak_gib is None else round(peak_gib, 2),
            "loss_first": curve[0],
            "loss_last50_mean": float(np.mean(curve[-50:])),
            "loss_min": float(np.min(curve)),
            "curve_every_20": [round(v, 3) for v in curve[::20]],
            "val_jf_curve": curve_jf,
            "checkpoint_step": config.ckpt_step,
            "checkpoint_save_wall_s": None if saved_wall is None else round(saved_wall, 2),
            "resume_replay_steps": len(replay_batches),
            "resume_state_bit_identical": True,
            "resume_bit_exact": bit_exact,
            "resume_max_rel_diff": rel,
            "replay_repeat_max_rel_diff": spread,
            "replay_losses_live": replay_live,
            "replay_losses_restored": replay,
            "replay_losses_repeat": repeat,
            "decreasing": bool(np.mean(curve[-50:]) < 0.5 * curve[0]),
        }
        if config.out:
            Path(config.out).parent.mkdir(parents=True, exist_ok=True)
            with open(config.out, "w") as f:
                json.dump(record, f, indent=1)
            print(f"wrote {config.out}")
        print(json.dumps({k: v for k, v in record.items() if k != "curve_every_20"}))
        held = max_rel_diff(replay[:REPLAY_HELD], replay_live[:REPLAY_HELD])
        if replay[:1] != replay_live[:1] or held > REPLAY_RTOL:
            raise RuntimeError(f"the resume replay's first losses {replay[:REPLAY_HELD]} differ "
                               f"from the live ones {replay_live[:REPLAY_HELD]} (the first must "
                               f"be equal, the first {REPLAY_HELD} within {REPLAY_RTOL} "
                               f"relative)")
        return record
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def get_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    d = LongRunConfig()
    ap = argparse.ArgumentParser("ocpg_tpu_torch.scripts.train_long_run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=d.steps)
    ap.add_argument("--ckpt_step", type=int, default=d.ckpt_step)
    ap.add_argument("--replay_steps", type=int, default=d.replay_steps)
    ap.add_argument("--eval_every", type=int, default=d.eval_every)
    ap.add_argument("--videos", type=int, default=d.videos)
    ap.add_argument("--frames_per_video", type=int, default=d.frames_per_video)
    ap.add_argument("--workers", type=int, default=d.workers)
    ap.add_argument("--keep_params", default=None,
                    help="also save the final train state to this checkpoint directory")
    ap.add_argument("--dataset", default=d.dataset, choices=["ytvos", "davis"],
                    help="ytvos: Ref-YouTube-VOS tree with h5 heatmaps; "
                         "davis: Ref-DAVIS tree of full palette-PNG masks")
    ap.add_argument("--out", default=d.out)
    ap.add_argument("--device", default=d.device, help="torch device (cpu for the tests)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = get_args(argv)
    return run(LongRunConfig(**vars(args)))


if __name__ == "__main__":
    main()
