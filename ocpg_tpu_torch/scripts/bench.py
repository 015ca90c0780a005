"""Benchmark: clip frames/s on one GPU of the A2D R101 eval forward, with
the Video Swin-B forward and the train step at B=1 and B=2 beside it, each
with its kernel-inclusive MFU.  The port of the root ``bench.py``.

    python -m ocpg_tpu_torch.scripts.bench

Prints ONE JSON line: ``{"metric", "value", "unit", ...}``.

Stages, at the JAX bench's configurations and shapes, random weights from
the configuration's seed, inputs ``synthetic_batch(default_rng(0))``
moved to the card once:

* ``headline``: ``a2d_r101_boxsup``, bf16, one 1 x 5 x 384 x 640 clip with
  ``valid_indices`` (the reference's inference scale: Resize 360, max 640,
  padded to /32), eval forward;
* ``swin_b``: the same with the ``video_swin_b_p4w7`` backbone;
* ``train_bs1``, ``train_bs2``: ``ytvos_r101_boxsup``, bf16, B=1 and B=2,
  T=3, 512 x 640, the full train step (forward with the matcher, losses,
  backward, clip, AdamW with ``lr_drop_steps=[10**9]``).

Environment, as the JAX script: ``OCPG_BENCH_BACKBONE`` benches only that
backbone (default ``resnet101``; another skips the companions),
``OCPG_BENCH_BATCH`` clips per forward (B > 1 skips the train stages),
``OCPG_BENCH_SKIP_SWIN=1`` and ``OCPG_BENCH_SKIP_TRAIN=1`` skip companions,
``OCPG_BENCH_BUDGET_S`` (default 900) is the wall-clock budget.

Method: a stage's time per iteration is the median over paired runs of
``(t_long - t_short) / (L - S)``; a run issues L or S forwards (or train
steps) back to back and ends in ``torch.cuda.synchronize()``, timed with
the host clock (the port's forward is host-bound, and that cost is what a
user pays).  The pair cancels the fixed cost of a run; the median drops a
stalled pair.  Forward stages use L/S = 32/4 over 5 pairs, train stages
16/2 over 3 (``scripts/bench_train.py``'s pairing).  No CUDA graphs and no
``torch.compile``.

FLOPs come from one untimed forward (or train step) of the same inputs:

* ``*_gflop_*_dense``: ``torch.utils.flop_counter.FlopCounterMode`` (the
  counterpart of XLA's cost analysis): the matmuls and convolutions of
  the aten ops it sees, backward included.  It does not count FFTs (the
  LFM filter), normalisations, softmax or elementwise work, which XLA's
  count includes.
* ``*_gflop_*_kernels``: the analytic entries of
  ``ops/ms_deform_attn.count_msda_flops``: every MSDA forward and backward
  (K1, K2) and every window-attention forward (K7).  The kernels run
  through ctypes, where ``FlopCounterMode`` cannot see them; the
  dispatchers also hide their forward from it, so nothing is counted
  twice (K7's backward is plain PyTorch and sits in the dense count).
* ``*_mfu_dense`` = dense / t / peak and ``*_mfu_incl_custom_calls`` =
  (dense + kernels) / t / peak, with peak the card's dense bf16 rate
  (``utils/hw.gpu_spec``; 989 TFLOP/s on an H100 SXM).  The record holds
  ``gpu_kind``, ``assumed_peak_tflops_bf16``, ``peak_is_fallback_guess``
  and ``nvidia_smi`` (the card's name and power limit).

Each stage also records its kernel launches (``launches``: K1-K7, the
counters reset before it) and the forwards or steps it ran (``calls``).

Emission is guaranteed: the line is printed exactly once, by whichever
comes first of the normal end, an exit through atexit, SIGTERM/SIGINT
(then the exit code is 128 + the signal) or a watchdog thread at budget +
90 s (exit code 1; it covers a main thread stuck in a device call).  A
stage runs only if the budget left covers its estimate; skipped stages are
listed in ``skipped`` and ``running_stage`` names the stage in flight.  A
stage that raises is listed as ``"<name>:failed"``, its traceback goes to
stderr, the later stages still run and the exit code is 1; there is no
retry.

``run(device="cpu", ...)`` runs on the CPU (the tests' way in, with
``measure``/``measure_train`` at a small configuration).
"""

from __future__ import annotations

import atexit
import contextlib
import gc
import json
import os
import signal
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

FRAMES, HEIGHT, WIDTH = 5, 384, 640
# (long, short, repeats) of the paired runs
EVAL_ITERS = (32, 4, 5)
TRAIN_ITERS = (16, 2, 3)
WARMUP = 2
BUDGET_S = 900.0
WATCHDOG_GRACE_S = 90.0

Iters = Tuple[int, int, int]


# ------------------------------------------------------------- measuring --
def sync_device(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def paired_median(run: Callable[[int], None], iters: Iters) -> float:
    """Seconds per iteration: the median over ``repeats`` paired runs of
    ``(t_long - t_short) / (long - short)``; ``run(n)`` issues n iterations
    and waits for the device."""
    long, short, repeats = iters
    deltas = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run(long)
        t_long = time.perf_counter() - t0
        t0 = time.perf_counter()
        run(short)
        deltas.append((t_long - (time.perf_counter() - t0)) / (long - short))
    return max(sorted(deltas)[len(deltas) // 2], 1e-9)


def _dense_flop_mode():
    """A dispatch mode that adds up ``torch.utils.flop_counter``'s count of
    every aten op it sees (``FlopCounterMode``'s registry and its
    decomposition rule), without ``FlopCounterMode``'s module tracker,
    which fails on a module called with a parameter under ``no_grad`` (the
    eval forward)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class DenseFlops(TorchDispatchMode):
        flops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            packet = func._overloadpacket
            if func not in flop_registry and packet not in flop_registry:
                with self:
                    out = func.decompose(*args, **kwargs)
                if out is not NotImplemented:
                    return out
            out = func(*args, **kwargs)
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
            return out

    return DenseFlops()


def count_flops(fn: Callable[[], Any]) -> Tuple[float, float]:
    """(dense, kernels) FLOPs of one ``fn()``: ``FlopCounterMode``'s count
    of the aten ops and the sum of the ``count_msda_flops`` entries (see
    the module docstring for what each covers)."""
    from ..ops.ms_deform_attn import count_msda_flops

    with count_msda_flops() as entries, _dense_flop_mode() as mode:
        fn()
    return float(mode.flops), float(sum(f for _, f in entries))


def peak_flops(device: torch.device) -> Dict[str, Any]:
    """The card's dense bf16 peak and the record keys that say which card
    it assumes."""
    from ..utils.hw import gpu_spec

    spec = gpu_spec(device if device.type == "cuda" else None)
    return {"gpu_kind": spec.kind, "peak": spec.peak_flops_bf16,
            "assumed_peak_tflops_bf16": round(spec.peak_flops_bf16 / 1e12, 1),
            "peak_is_fallback_guess": spec.assumed}


def bench_batch(bsz: int, frames: int, height: int, width: int,
                vocab_size: int = 50265) -> Dict[str, Any]:
    """The stages' host batch: ``synthetic_batch(default_rng(0))``, the
    JAX bench's."""
    from ..data.synthetic import synthetic_batch

    return synthetic_batch(np.random.default_rng(0), batch=bsz, frames=frames,
                           height=height, width=width, vocab_size=vocab_size)


class _Counted:
    """``fn()`` that counts its calls; ``run(n)`` calls it n times and waits
    for the device."""

    def __init__(self, fn: Callable[[], Any], device: torch.device):
        self.fn, self.device, self.calls = fn, device, 0

    def __call__(self):
        self.calls += 1
        return self.fn()

    def run(self, n: int) -> None:
        for _ in range(n):
            self()
        sync_device(self.device)


def _throughput(one: _Counted, iters: Iters) -> Tuple[float, Dict[str, float]]:
    """Warm ``one`` up, count one call's FLOPs and time it: (seconds per
    call, {"mfu_dense", "mfu_incl", "gflop_dense", "gflop_kernels"})."""
    one.run(WARMUP)
    dense, kernels = count_flops(one)
    dt = paired_median(one.run, iters)
    peak = peak_flops(one.device)["peak"]
    return dt, {"mfu_dense": dense / dt / peak, "mfu_incl": (dense + kernels) / dt / peak,
                "gflop_dense": dense / 1e9, "gflop_kernels": kernels / 1e9}


def train_step(cfg, device):
    """A fresh model of ``cfg`` on ``device`` with AdamW (``lr_drop_steps=
    [10**9]``) in a ``TrainStep``."""
    from ..engine.optim import build_optimizer
    from ..engine.train import TrainStep
    from ..models.build import build_model, build_weight_dict, criterion_config

    model = build_model(cfg, device)
    optimizer = build_optimizer(model, cfg, [10 ** 9])
    return TrainStep(model, criterion_config(cfg), build_weight_dict(cfg), optimizer)


def measure(backbone: str, bsz: int, *, device="cuda", cfg=None, frames: int = FRAMES,
            height: int = HEIGHT, width: int = WIDTH,
            iters: Iters = EVAL_ITERS) -> Dict[str, Any]:
    """Eval-forward throughput of ``a2d_r101_boxsup`` (bf16, ``backbone``)
    or of ``cfg``: {"fps", "mfu_dense", "mfu_incl", "gflop_dense",
    "gflop_kernels", "calls"}."""
    from ..config import a2d_r101_boxsup
    from ..models.build import build_model, resolve_device

    device = resolve_device(device)
    if cfg is None:
        cfg = a2d_r101_boxsup().replace(compute_dtype="bfloat16", backbone=backbone)
    model = build_model(cfg, device)
    host = bench_batch(bsz, frames, height, width, cfg.text_vocab)
    args = [torch.from_numpy(np.asarray(host[k])).to(device)
            for k in ("samples", "samples_mask", "text_ids", "text_mask")]
    args.append(torch.from_numpy(host["targets"]["size"]).to(device))
    vi = torch.zeros((bsz,), dtype=torch.int32, device=device)
    one = _Counted(lambda: model(*args, vi)["pred_masks"], device)
    dt, rates = _throughput(one, iters)
    return {"fps": bsz * frames / dt, **rates, "calls": one.calls}


def measure_train(backbone: str = "resnet101", bsz: int = 1, frames: int = 3,
                  height: int = 512, width: int = 640, *, device="cuda", cfg=None,
                  iters: Iters = TRAIN_ITERS, profile: bool = False) -> Dict[str, Any]:
    """Train-step throughput (forward with the matcher, losses, backward,
    clip, AdamW) of ``ytvos_r101_boxsup`` (bf16, ``backbone``, T=frames) or
    of ``cfg``, on one batch resident on the device: {"step_ms", "fps",
    "mfu_dense", "mfu_incl", "gflop_dense", "gflop_kernels", "loss",
    "calls"}; with ``profile``, also "profile": one more step under
    ``utils/profiling.profile_run`` (None without device time)."""
    from ..config import ytvos_r101_boxsup
    from ..engine.train import _to_device
    from ..models.build import resolve_device

    device = resolve_device(device)
    if cfg is None:
        cfg = ytvos_r101_boxsup().replace(compute_dtype="bfloat16", backbone=backbone,
                                          num_frames=frames)
    step = train_step(cfg, device)
    batch = _to_device(bench_batch(bsz, frames, height, width, cfg.text_vocab), device)
    one = _Counted(lambda: step(batch), device)
    dt, rates = _throughput(one, iters)
    out = {"step_ms": dt * 1e3, "fps": bsz * frames / dt, **rates, "loss": one()["loss"]}
    if profile:
        from ..utils.profiling import profile_run

        out["profile"] = profile_run(f"one train step ({cfg.backbone}, B={bsz}, T={frames}, "
                                     f"{height}x{width})", one)
    out["calls"] = one.calls
    return out


# -------------------------------------------------------------- emission --
class _Run:
    """The record, its single emission and the stage plan's bookkeeping."""

    def __init__(self, record: Dict[str, Any], budget_s: float):
        self.record = record
        self.budget_s = budget_s
        self.t0 = time.monotonic()
        self.failed = False
        self._lock = threading.Lock()
        self._emitted = False
        self._done = threading.Event()

    def elapsed(self) -> float:
        return time.monotonic() - self.t0

    def emit(self) -> None:
        with self._lock:
            if self._emitted:
                return
            self._emitted = True
            self.record["wall_s"] = round(self.elapsed(), 1)
            sys.stdout.write(json.dumps(self.record) + "\n")
            sys.stdout.flush()

    def _on_signal(self, signum, frame):
        print(f"bench: signal {signum} at {self.elapsed():.0f}s: emitting the partial "
              "record", file=sys.stderr, flush=True)
        self.emit()
        os._exit(128 + signum)

    def _watchdog(self):
        if self._done.wait(max(self.budget_s + WATCHDOG_GRACE_S - self.elapsed(), 0.0)):
            return
        print(f"bench: watchdog fired at {self.elapsed():.0f}s: emitting the partial "
              "record and exiting", file=sys.stderr, flush=True)
        self.emit()
        os._exit(1)

    @contextlib.contextmanager
    def guarded(self) -> Iterator[None]:
        """atexit, SIGTERM/SIGINT (from the main thread) and the watchdog
        while inside; emits on the way out and puts the handlers back."""
        atexit.register(self.emit)
        saved = {}
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                saved[sig] = signal.signal(sig, self._on_signal)
        threading.Thread(target=self._watchdog, daemon=True).start()
        try:
            yield
        finally:
            self.emit()
            self._done.set()
            for sig, handler in saved.items():
                signal.signal(sig, handler)
            atexit.unregister(self.emit)

    def budget_allows(self, stage: str, est_s: float) -> bool:
        remaining = self.budget_s - self.elapsed()
        if est_s <= remaining:
            return True
        print(f"bench: skipping {stage} (est {est_s:.0f}s > remaining {remaining:.0f}s of "
              f"{self.budget_s:.0f}s budget)", file=sys.stderr, flush=True)
        self.record["skipped"].append(stage)
        return False

    def stage(self, name: str, fn: Callable[[], Optional[int]]) -> None:
        """Run one stage: its wall time, launches and calls recorded, a
        failure listed as "<name>:failed" (no retry)."""
        from ..utils.profiling import launch_counts, reset_launch_counts

        t0 = time.monotonic()
        self.record["running_stage"] = name
        reset_launch_counts()
        try:
            self.record["calls"][name] = fn()
            self.record["launches"][name] = launch_counts()
        except Exception:
            traceback.print_exc()
            print(f"bench: stage {name} failed", file=sys.stderr, flush=True)
            self.record["skipped"].append(f"{name}:failed")
            self.failed = True
        finally:
            self.record["stage_wall_s"][name] = round(time.monotonic() - t0, 1)
            self.record["running_stage"] = None
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()


def run(device="cuda", eval_iters: Iters = EVAL_ITERS,
        train_iters: Iters = TRAIN_ITERS) -> Tuple[Dict[str, Any], int]:
    """Every stage the environment asks for; returns (record, exit code)."""
    from ..models.build import resolve_device
    from ..utils.hw import nvidia_smi_line

    device = resolve_device(device)
    backbone = os.environ.get("OCPG_BENCH_BACKBONE", "resnet101")
    # OCPG_BENCH_BATCH > 1 measures batched serving throughput (several
    # clips per dispatch, as ClipInferenceEngine(per_device_batch > 1) issues them)
    bsz = int(os.environ.get("OCPG_BENCH_BATCH", "1"))
    tag = "a2d_r101" if backbone == "resnet101" else f"a2d_{backbone}"
    if bsz > 1:
        tag += f"_b{bsz}"
    peak = peak_flops(device)
    record: Dict[str, Any] = {
        "metric": f"clip_frames_per_sec_per_chip_{tag}",
        "value": 0.0,
        "unit": "frames/sec/chip",
        "budget_s": float(os.environ.get("OCPG_BENCH_BUDGET_S", BUDGET_S)),
        "skipped": [],
        "stage_wall_s": {},
        "running_stage": None,
        "launches": {},
        "calls": {},
        **{k: v for k, v in peak.items() if k != "peak"},
        "nvidia_smi": nvidia_smi_line() if device.type == "cuda" else None,
    }
    bench = _Run(record, record["budget_s"])
    rec = record    # the stages' results merge into it as each lands

    def eval_stage(prefix: str, stage_backbone: str) -> int:
        r = measure(stage_backbone, bsz, device=device, iters=eval_iters)
        if prefix:
            rec[f"{prefix}fps"] = round(r["fps"], 2)
        else:
            rec["value"] = round(r["fps"], 2)
        rec[f"{prefix}model_mfu_dense"] = round(r["mfu_dense"], 4)
        rec[f"{prefix}model_mfu_incl_custom_calls"] = round(r["mfu_incl"], 4)
        rec[f"{prefix}model_gflop_per_clip_dense"] = round(r["gflop_dense"], 3)
        rec[f"{prefix}model_gflop_per_clip_kernels"] = round(r["gflop_kernels"], 3)
        return r["calls"]

    def train_stage(prefix: str, batch: int) -> int:
        r = measure_train(bsz=batch, device=device, iters=train_iters)
        rec[f"{prefix}step_ms"] = round(r["step_ms"], 1)
        rec[f"{prefix}frames_per_sec_per_chip"] = round(r["fps"], 2)
        rec[f"{prefix}mfu_dense"] = round(r["mfu_dense"], 4)
        rec[f"{prefix}mfu_incl_custom_calls"] = round(r["mfu_incl"], 4)
        rec[f"{prefix}gflop_per_step_dense"] = round(r["gflop_dense"], 3)
        rec[f"{prefix}gflop_per_step_kernels"] = round(r["gflop_kernels"], 3)
        return r["calls"]

    with bench.guarded():
        bench.stage("headline", lambda: eval_stage("", backbone))
        headline_wall = rec["stage_wall_s"]["headline"]
        # the second half of the JAX package's north-star ("A2D R101 + VideoSwin-B")
        if backbone == "resnet101" and not os.environ.get("OCPG_BENCH_SKIP_SWIN"):
            if bench.budget_allows("swin_b", est_s=1.6 * headline_wall + 60):
                bench.stage("swin_b", lambda: eval_stage("swin_b_", "video_swin_b_p4w7"))
        # the train step at B=1 (latency) and B=2 (the reference recipe's
        # per-GPU batch)
        if backbone == "resnet101" and bsz == 1 and not os.environ.get("OCPG_BENCH_SKIP_TRAIN"):
            if bench.budget_allows("train_bs1", est_s=1.2 * headline_wall + 30):
                bench.stage("train_bs1", lambda: train_stage("train_", 1))
            t1_wall = rec["stage_wall_s"].get("train_bs1")
            if t1_wall is None:
                rec["skipped"].append("train_bs2")
            elif bench.budget_allows("train_bs2", est_s=1.0 * t1_wall + 30):
                bench.stage("train_bs2", lambda: train_stage("train_b2_", 2))
    return record, 1 if bench.failed else 0


def main() -> int:
    return run()[1]


if __name__ == "__main__":
    sys.exit(main())
