#!/usr/bin/env python3
"""Drive the PyTorch port (``ocpg_tpu_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

It takes no arguments and runs every phase; each fails the run (non-zero
exit, no result line) if it goes wrong:

1. build      -- compile every CUDA kernel of the port from
                 ocpg_tpu_torch/ops/csrc (one nvcc per source, all started
                 together).
2. kernel     -- each kernel against its plain PyTorch version on the card,
                 in float32 and bfloat16: the MSDA forward (K1) at the
                 serving, A2D and train calls, with samples outside the map,
                 on integer pixel coordinates (xp = -1 among them) and at
                 NaN/inf coordinates; its backward (K2) at the serving and
                 train calls (encoder and decoder, Lq = 5) against autograd
                 through the plain version; at the serving and train encoder
                 calls both also on clustered samples (each query within
                 +-2 pixels of its reference point, as a trained encoder
                 samples); their standard-layout entries (K3 at the encoder
                 calls, K4 at K2's calls) on the same samples in the
                 standard layout; the dense-row (K5) and fused-K (K6)
                 forwards against the plain gather version at the encoder
                 calls, uniform and clustered, and at the decoder calls
                 (Lq = 5, a ragged query tile), timed at the encoder calls
                 with the tensor-core FLOPs they execute; the memory-fusion bicubic resize (two bf16
                 products) against the CPU, forward and gradient, timed
                 beside F.interpolate's bicubic at the train call; the Swin
                 window attention (K7) at the four Video Swin-B serving calls
                 (n = 245) and the four Swin-B train calls (n = 147, a
                 ragged last row tile, whose rows are also held apart) with
                 and without the SW-MSA mask, at a 2D Swin (n = 49) call and
                 at its edges (n = 392, an odd n = 13), its autograd
                 Function's gradients against autograd through the plain
                 version (serving stages 0 and 3, train stage 0).  Each
                 kernel's device time (the launches queue behind a sleep
                 kernel, so the host's launch rate does not count), the
                 plain version's, the bound and, for K7,
                 scaled_dot_product_attention's, with the host's enqueue
                 time per call beside both.
3. card       -- the small models on the card (through the kernels) against
                 the same weights on the CPU (through the plain versions),
                 TF32 off: the ResNet eval forward (both branches) and the
                 Video Swin eval forward (DAVIS branch) at the bounds of
                 tests/test_golden_parity.py, and one train step with dropout
                 and stochastic depth off (matched queries identical, every
                 loss and grad_norm within 1e-3 relative, K1 and K2 each
                 launched once per transformer layer) of the ResNet model,
                 of the Video Swin model (K7 once per block), of the Video
                 Swin model with use_checkpoint (K7 twice per block: forward
                 and recompute) and of the ResNet model with the BoxInst
                 pairwise loss on a 3-frame clip.
4. serve      -- the full-width YTVOS R101 model (ResNet-101, RoBERTa-base,
                 4+4 layers, bf16) behind ClipInferenceEngine, answering
                 uint8 requests of mixed sizes; every answer has its
                 request's shape and is finite, MSDA launched 8 times per
                 dispatch and its backward never.
5. a2d        -- the A2D R101 eval forward on one 5 x 384 x 640 clip (bf16,
                 valid_indices): finite masks of shape (1, 1, 5, 384, 640),
                 MSDA launched 8 times in the forward and its backward never.
6. train      -- the full-width YTVOS R101 train step (forward, matcher, the
                 weak-supervision losses, backward, clip, AdamW; bf16 with
                 float32 parameters, dropout on) on one 3 x 512 x 640 clip: K1
                 and K2 each launched 8 times in a step, every loss and the
                 grad norm finite, the trained parameters moved and the frozen
                 ones (ResNet stem and layer1, text encoder) bit-identical;
                 then ms/step over 5 steps, peak memory, and one step under
                 torch.profiler.
7. swin_serve -- the full-width DAVIS Video Swin-B model (davis_videoswin_base:
                 embed 128, depths 2/2/18/2, RoBERTa-base, 4+4 layers, bf16)
                 behind the same engine and requests as phase serve: K7
                 launched 24 times per dispatch, K1 8 times, K2 never;
                 frames/s and one dispatch under torch.profiler.
8. swin_a2d   -- the A2D eval forward with the Video Swin-B backbone on one
                 5 x 384 x 640 clip (bf16, valid_indices): K7 launched 24
                 times, K1 8 times.
9. swin_train -- the JAX bench's Swin-B train stage: ytvos_r101_boxsup
                 with the Video Swin-B backbone, B=1, T=3, 512 x 640, bf16,
                 dropout and stochastic depth on, the batch in the compact
                 wire (uint8 frames and masks, float16 heatmaps), run as
                 phase train runs, once without per-block recompute (path
                 swin_train: K7 24 times a step) and once with it
                 (swin_train_recompute: 48), K1 and K2 8 times each, the
                 frozen text encoder bit-identical; ms/step, peak memory,
                 and a profile with K7's forward and its plain recompute
                 backward (the kernels under the Function's backward).
10. resume    -- two train steps of the small model, a checkpoint save and a
                 restore into a fresh model, optimizer and step: state dicts
                 and generator state bit-identical to the saved ones, the
                 next step's losses within 1e-3 relative on both sides.
11. train_cli -- the port's train CLI (``ocpg_tpu_torch.cli.train``) in this
                 process, as a user runs it: the full-width ytvos_r101_boxsup
                 model (ResNet-101, bf16, canvas 512 x 640, B=1, T=3) on a
                 seeded Ref-DAVIS tree of 8 frames at 720 x 1280 (JPEG frames
                 written with PIL, palette-PNG masks written with zlib), one
                 epoch, then --resume for a second: K1 and K2 8 times per
                 step over every step of both runs, K3-K7 never, no cv2
                 loaded, every logged loss finite, log.txt with epochs 0 and
                 1, the latest checkpoint at 2 x 8 steps, the frozen ResNet
                 stem and text encoder bit-identical to their init; steps/s,
                 the data-wait share, the loader's batches/s alone, one
                 compact batch's pinned copy (device ms), peak memory.
12. std_op     -- the standard-layout MSDA op ``ms_deform_attn_fast`` once
                 forward and backward at the train encoder call: K3 and K4
                 launched once each, the gradients finite.
13. msda_bench -- the port's MSDA kernel bench in this process
                 (``ocpg_tpu_torch.scripts.bench_msda_kernel``, variants cm
                 r4 fk sep, --bwd, eval shapes, checked against sep): every
                 check within 2e-2, K1, K2, K5 and K6 each launched.

Every launch counter (K1-K7) is reset just before each of the phases
serve, a2d, train, swin_serve, swin_a2d, swin_train (each of its two runs),
resume, train_cli (each of its two runs), std_op and msda_bench runs its
path and read just after; the
``kernels`` line gives each kernel's count on every path.

It imports nothing of JAX.  The last three lines of its output are the
card's name and power limit (nvidia-smi), one JSON object listing the
kernels, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ocpg_tpu_torch.config import (OCPGConfig, a2d_r101_boxsup, davis_videoswin_base,
                                   ytvos_r101_boxsup)
from ocpg_tpu_torch.data.synthetic import synthetic_batch
from ocpg_tpu_torch.engine.checkpoint import CheckpointManager
from ocpg_tpu_torch.engine.infer import ClipInferenceEngine, InferRequest
from ocpg_tpu_torch.engine.optim import build_optimizer, param_group_label
from ocpg_tpu_torch.engine.train import make_train_step
from ocpg_tpu_torch.models import backbone_video_swin as video_swin
from ocpg_tpu_torch.models.build import build_model, build_weight_dict, criterion_config
from ocpg_tpu_torch.models.text_encoder import SimpleTokenizer
from ocpg_tpu_torch.ops import _build
from ocpg_tpu_torch.ops import image
from ocpg_tpu_torch.ops import ms_deform_attn as msda
from ocpg_tpu_torch.ops import ms_deform_attn_variants as msda_var
from ocpg_tpu_torch.ops import window_attention as wattn
from ocpg_tpu_torch.scripts import bench_msda_kernel
# the model's MSDA (M, D), the serving and train paths' levels and frames,
# and the seeded MSDA inputs (uniform or clustered samples)
from ocpg_tpu_torch.scripts.bench_msda_bwd import (HEAD_DIM, HEADS, SERVE_N, SERVE_SHAPES,
                                                   TRAIN_N, TRAIN_SHAPES, msda_inputs)

# H100 SXM (NVIDIA's data sheet): HBM rate, float32 rate outside the tensor
# cores, dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
# cycles per second of torch.cuda._sleep's spin (an SM clock at or above the
# card's; a slower clock only lengthens the sleep)
SLEEP_CYCLES_PER_S = 2.0e9
# the decoder calls' queries (Lq = 5)
QUERIES = 5
# Swin-B serving path (video_swin_b_p4w7, one 5 x 384 x 640 clip): the token
# grid and heads of each stage; the (8, 7, 7) window clamps to T = 5, n = 245
SWIN_T, SWIN_WINDOW, SWIN_HEAD_DIM = 5, (8, 7, 7), 32
SWIN_GRIDS = ((96, 160), (48, 80), (24, 40), (12, 20))
SWIN_HEADS = (4, 8, 16, 32)
SWIN_B_BLOCKS = 24
# Swin-B train path (one 3 x 512 x 640 clip): the window clamps to T = 3,
# n = 147 = 9 x 16 + 3, so the tensor-core body has a ragged last row tile;
# windows per stage of a shifted block
SWIN_TRAIN_T = 3
SWIN_TRAIN_GRIDS = ((128, 160), (64, 80), (32, 40), (16, 20))
SWIN_TRAIN_WINDOWS = (437, 120, 30, 9)
# launch counters of the port's kernels: (name, module, attribute)
COUNTERS = (("K1", msda, "launches"), ("K2", msda, "bwd_launches"),
            ("K3", msda, "std_launches"), ("K4", msda, "std_bwd_launches"),
            ("K5", msda_var, "r4_launches"), ("K6", msda_var, "fk_launches"),
            ("K7", wattn, "launches"))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_times(fn, iters: int, warmup: int = 3):
    """(device ms, host ms) per call of fn() over iters calls.  The calls
    queue up behind a sleep kernel that outlasts the host's enqueueing, so
    the CUDA events around them time the device, not the rate at which the
    host launches; the host's enqueue time per call is returned beside it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * once * iters + 1e-3, 2.0) * SLEEP_CYCLES_PER_S))
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over iters launches (cuda_times)."""
    return cuda_times(fn, iters, warmup)[0]


# ------------------------------------------------------------------ kernel --
def in_map_corners(shapes, x, y):
    """How many bilinear corners of these samples fall inside their map."""
    corners = 0
    for lid, (h, w) in enumerate(shapes):
        xp = x[:, :, lid] * w - 0.5
        yp = y[:, :, lid] * h - 0.5
        x0, y0 = torch.floor(xp), torch.floor(yp)
        for cx, cy in ((x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1, y0 + 1)):
            corners += int(((cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1)).sum())
    return corners


def msda_work(shapes, value, x, y, aw):
    """(bytes, flops) the forward needs on these inputs: each input read
    once, the output written once; per in-map corner one weight product and
    a multiply-add per channel."""
    n, s, m, d = value.shape
    nbytes = (value.numel() * value.element_size() + 3 * x.numel() * 4
              + n * x.shape[-1] * m * d * value.element_size())
    return nbytes, in_map_corners(shapes, x, y) * (2 * d + 2) + x.numel() * 12


def msda_bwd_work(shapes, value, x, y, aw):
    """(bytes, flops) the backward needs on these inputs: value, g, x, y and
    aw read once, d_value, d_x, d_y and d_aw written once; per in-map corner
    and channel the multiply-add of t_c = sum_d g * v_c and the product
    (aw * w_c) * g added into d_value; per sample the coordinates, the four
    weights and their products with aw, and d_aw, d_x, d_y as sums over
    the four t_c."""
    n, s, m, d = value.shape
    gbytes = n * x.shape[-1] * m * d * value.element_size()
    nbytes = 2 * value.numel() * value.element_size() + gbytes + 6 * x.numel() * 4
    return nbytes, in_map_corners(shapes, x, y) * 4 * d + x.numel() * 40


def reset_counts() -> None:
    for _, mod, attr in COUNTERS:
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(mod, attr) for name, mod, attr in COUNTERS}


def counts_of(**launched) -> dict:
    """The expected counts of a path: the named kernels, every other one 0."""
    return {name: launched.get(name, 0) for name, _, _ in COUNTERS}


def timed_bound(nbytes, flops, flops_per_s=F32_FLOPS_PER_S):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / flops_per_s * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def phase_kernel(results):
    """K1 at the calls the main paths make: the serving encoder and decoder
    (N = clip_len frames), the A2D ones (valid_indices leaves N = 1) and the
    train ones (N = B x T = 3 frames at 512 x 640); K2 at the serving and
    train calls.  The serving and train encoder calls run on uniform and on
    clustered samples (msda_inputs)."""
    lq_serve = sum(h * w for h, w in SERVE_SHAPES)
    lq_train = sum(h * w for h, w in TRAIN_SHAPES)
    calls = (("serve encoder", SERVE_SHAPES, SERVE_N, lq_serve),
             ("serve decoder", SERVE_SHAPES, SERVE_N, QUERIES),
             ("a2d encoder", SERVE_SHAPES, 1, lq_serve),
             ("a2d decoder", SERVE_SHAPES, 1, QUERIES),
             ("train encoder", TRAIN_SHAPES, TRAIN_N, lq_train),
             ("train decoder", TRAIN_SHAPES, TRAIN_N, QUERIES))
    report = {}
    for name, shapes, n, lq in calls:
        with_bwd = not name.startswith("a2d")
        kinds = (False, True) if with_bwd and name.endswith("encoder") else (False,)
        for clustered in kinds:
            tag = f"{name} clustered" if clustered else name
            for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
                value, x, y, aw = msda_inputs(shapes, n, lq, dtype, seed=7, clustered=clustered)
                got = msda.ms_deform_attn_cm(value, shapes, x, y, aw)
                torch.cuda.synchronize()
                want = msda.ms_deform_attn_cm_reference(value.float(), shapes, x, y, aw)
                label = f"{tag} N={n} Lq={lq} {str(dtype)[6:]}"
                err = held(f"K1 msda {label}", got, want, tol)
                if dtype == torch.bfloat16:
                    ms = cuda_ms(lambda: msda.ms_deform_attn_cm(value, shapes, x, y, aw), 50)
                    plain_ms = cuda_ms(lambda: msda.ms_deform_attn_cm_reference(
                        value, shapes, x, y, aw), 10)
                    nbytes, flops = msda_work(shapes, value, x, y, aw)
                    bound_ms, bound_by = timed_bound(nbytes, flops)
                    gather_bytes = x.numel() * 4 * HEAD_DIM * value.element_size()
                    log(f"kernel msda {tag} bf16: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                        f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB, "
                        f"{flops / 1e9:.3f} GFLOP f32); corner gathers "
                        f"{gather_bytes / 1e9:.3f} GB = "
                        f"{gather_bytes / (ms * 1e-3) / 1e12:.2f} TB/s through L2/L1")
                    report[tag] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                       bound_by=bound_by, max_abs_err=err)
                if not with_bwd:
                    continue
                # K2 at the same call: each gradient against autograd through
                # the plain version, within tol x its own max |.|.  The order
                # of d_value's atomic sums changes from run to run.
                g = torch.randn(n, lq, HEADS * HEAD_DIM, generator=torch.Generator(
                    device="cuda").manual_seed(9), device="cuda").to(dtype)
                got = msda.ms_deform_attn_cm_backward(value, shapes, x, y, aw, g)
                torch.cuda.synchronize()
                want = msda.ms_deform_attn_cm_grad_reference(value.float(), shapes, x, y, aw,
                                                             g.float())
                err = held_grads(f"K2 msda_bwd {label}", got, want,
                                 ("d_value", "d_x", "d_y", "d_aw"), tol, dtype)
                del got, want
                if dtype == torch.bfloat16:
                    ms, plain_ms = time_bwd(
                        lambda: msda.ms_deform_attn_cm_backward(value, shapes, x, y, aw, g),
                        lambda v, *p: msda.ms_deform_attn_cm_reference(v, shapes, *p),
                        (value, x, y, aw), g)
                    nbytes, flops = msda_bwd_work(shapes, value, x, y, aw)
                    bound_ms, bound_by = timed_bound(nbytes, flops)
                    log(f"kernel msda_bwd {tag} bf16: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                        f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB, "
                        f"{flops / 1e9:.3f} GFLOP f32)")
                    report[f"bwd {tag}"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                                bound_by=bound_by, max_abs_err=err)
    results["msda"] = report["serve encoder"]
    results["msda_train"] = report["train encoder"]
    results["msda_calls"] = {k: v for k, v in report.items() if not k.startswith("bwd ")}
    results["msda_bwd"] = report["bwd train encoder"]
    results["msda_bwd_calls"] = {k[4:]: v for k, v in report.items() if k.startswith("bwd ")}
    msda_other_kernel_checks(results)
    dense_row_kernel_checks(results)
    resize_checks(results)
    wattn_kernel_checks(results)


def held_grads(label, got, want, names, tol, value_dtype):
    """Each gradient of a backward kernel against autograd through the plain
    version (held: within tol x its own max |.|); d_value in the value's
    type, the others float32.  Returns the largest error."""
    worst = 0.0
    for gname, a, b in zip(names, got, want):
        check(a.dtype == (value_dtype if gname == "d_value" else torch.float32),
              f"{label} {gname} dtype {a.dtype}")
        worst = max(worst, held(f"{label} {gname}", a, b, tol))
    return worst


def time_bwd(fn, plain_fwd, inputs, g):
    """(device ms of a backward kernel's wrapper fn(), device ms of the plain
    backward alone): autograd through a graph of plain_fwd(*inputs) built
    once, outside the timed calls."""
    ms = cuda_ms(fn, 20)
    inputs = [t.detach().requires_grad_() for t in inputs]
    with torch.enable_grad():
        out = plain_fwd(*inputs)
    plain_ms = cuda_ms(lambda: torch.autograd.grad(out, inputs, g, retain_graph=True), 5)
    return ms, plain_ms


def held(label, got, want, limit):
    """max |got - want| against limit x max |want|; returns the error."""
    check(bool(torch.isfinite(want).all()), f"{label}: plain version not finite")
    err = (got.float() - want).abs().max().item()
    scale = want.abs().max().item()
    check(math.isfinite(err) and err <= limit * scale,
          f"{label}: max |kernel - plain| {err} > {limit} x max {scale}")
    log(f"kernel {label}: max_abs_err {err:.3e} (limit {limit} x {scale:.4g})")
    return err


def msda_other_kernel_checks(results):
    """The standard-layout entries K3 (forward) and K4 (backward) on
    msda_inputs in the standard layout (out-of-map, integer and NaN/inf
    samples), against their plain versions with K1's and K2's limits: K3 at
    the serving and train encoder calls, K4 at K2's calls (the encoder ones
    on uniform and clustered samples, and the decoder ones).  Then times in
    bf16."""
    calls = (("serve encoder", SERVE_SHAPES, SERVE_N), ("train encoder", TRAIN_SHAPES, TRAIN_N))
    for name, shapes, n in calls:
        lq = sum(h * w for h, w in shapes)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            tag = f"{name} N={n} Lq={lq} {str(dtype)[6:]}"
            value, x, y, aw = msda_inputs(shapes, n, lq, dtype, seed=7)
            locs, attn = msda._cm_to_standard(x, y, aw)
            got = msda.ms_deform_attn_fast(value, shapes, locs, attn)
            torch.cuda.synchronize()
            err3 = held(f"K3 msda_std {tag}", got,
                        msda.ms_deform_attn_reference(value.float(), shapes, locs, attn), tol)
            del got
            if dtype != torch.bfloat16:
                continue
            bound_ms, bound_by = timed_bound(*msda_work(shapes, value, x, y, aw))
            ms = cuda_ms(lambda: msda.ms_deform_attn_fast(value, shapes, locs, attn), 50)
            plain_ms = cuda_ms(lambda: msda.ms_deform_attn_reference(value, shapes, locs, attn),
                               10, warmup=1)
            log(f"kernel K3 {name} bf16: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms by {bound_by}")
            results.setdefault("K3", {})[name] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err3)

    # K4 at K2's calls, against the plain backward, timed alone as K2 is
    for name, shapes, n, lq in (
            ("serve encoder", SERVE_SHAPES, SERVE_N, sum(h * w for h, w in SERVE_SHAPES)),
            ("serve decoder", SERVE_SHAPES, SERVE_N, QUERIES),
            ("train encoder", TRAIN_SHAPES, TRAIN_N, sum(h * w for h, w in TRAIN_SHAPES)),
            ("train decoder", TRAIN_SHAPES, TRAIN_N, QUERIES)):
        for clustered in ((False, True) if name.endswith("encoder") else (False,)):
            call = f"{name} clustered" if clustered else name
            for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
                value, x, y, aw = msda_inputs(shapes, n, lq, dtype, seed=7, clustered=clustered)
                locs, attn = msda._cm_to_standard(x, y, aw)
                g = torch.randn(n, lq, HEADS * HEAD_DIM, generator=torch.Generator(
                    device="cuda").manual_seed(9), device="cuda").to(dtype)
                got = msda.ms_deform_attn_backward(value, shapes, locs, attn, g)
                torch.cuda.synchronize()
                want = msda.ms_deform_attn_grad_reference(value.float(), shapes, locs, attn,
                                                          g.float())
                err = held_grads(f"K4 msda_std_bwd {call} N={n} Lq={lq} {str(dtype)[6:]}",
                                 got, want, ("d_value", "d_locs", "d_attn"), tol, dtype)
                del got, want
                if dtype != torch.bfloat16:
                    continue
                ms, plain_ms = time_bwd(
                    lambda: msda.ms_deform_attn_backward(value, shapes, locs, attn, g),
                    lambda v, *p: msda.ms_deform_attn_reference(v, shapes, *p),
                    (value, locs, attn), g)
                bound_ms, bound_by = timed_bound(*msda_bwd_work(shapes, value, x, y, aw))
                log(f"kernel K4 {call} bf16: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"bound {bound_ms:.4f} ms by {bound_by}")
                results.setdefault("K4", {})[call] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                    max_abs_err=err)


def dense_row_kernel_checks(results):
    """The dense-row (K5) and fused-K (K6) forwards against the plain gather
    version within 2e-2 x max |out|, the bound of
    tests/test_ms_deform_attn_pallas.py for the TPU's dense-row and fused-K
    kernels (they round their tensor-core operands to bf16 in both dtypes),
    float32 and bfloat16, at the serving and train encoder calls on uniform
    and on clustered samples and at the decoder calls (Lq = 5, a ragged
    query tile); every input has out-of-map, integer and NaN/inf samples,
    where K5 and K6 sample nothing, as K1 and the plain version do.  Then bf16
    times at the encoder calls, uniform and clustered, with the tensor-core
    FLOPs each kernel executes on those samples (r4_mma_flops, fk_mma_flops)
    and the rate they reach."""
    kernels = (("K5", msda_var.ms_deform_attn_cm_r4, msda_var.ms_deform_attn_cm_r4_reference,
                msda_var.r4_mma_flops),
               ("K6", msda_var.ms_deform_attn_cm_fk, msda_var.ms_deform_attn_cm_fk_reference,
                msda_var.fk_mma_flops))
    for name, shapes, n in (("serve", SERVE_SHAPES, SERVE_N), ("train", TRAIN_SHAPES, TRAIN_N)):
        s = sum(h * w for h, w in shapes)
        for call, lq, clustered in ((f"{name} encoder", s, False),
                                    (f"{name} encoder clustered", s, True),
                                    (f"{name} decoder", QUERIES, False)):
            for dtype in (torch.float32, torch.bfloat16):
                value, x, y, aw = msda_inputs(shapes, n, lq, dtype, seed=7, clustered=clustered)
                want = msda.ms_deform_attn_cm_reference(value.float(), shapes, x, y, aw)
                tag = f"{call} N={n} Lq={lq} {str(dtype)[6:]}"
                errs = {}
                for kname, fn, _, _ in kernels:
                    got = fn(value, shapes, x, y, aw)
                    torch.cuda.synchronize()
                    check(got.dtype == dtype, f"{kname} {tag}: output dtype {got.dtype}")
                    errs[kname] = held(f"{kname} {tag}", got, want, 2e-2)
                    del got
                del want
                if dtype != torch.bfloat16 or call.endswith("decoder"):
                    continue
                bound_ms, bound_by = timed_bound(*msda_work(shapes, value, x, y, aw))
                for kname, fn, plain, count in kernels:
                    ms = cuda_ms(lambda: fn(value, shapes, x, y, aw), 20)
                    plain_ms = cuda_ms(lambda: plain(value, shapes, x, y, aw), 3, warmup=1)
                    mma = count(shapes, x, y, HEAD_DIM)
                    entry = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                 max_abs_err=errs[kname], mma_gflop=mma / 1e9,
                                 mma_bound_ms=mma / BF16_FLOPS_PER_S * 1e3,
                                 mma_tflops=mma / (ms * 1e-3) / 1e12)
                    log(f"kernel {kname} {call} bf16: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                        f"bound {bound_ms:.4f} ms by {bound_by}; executes "
                        f"{entry['mma_gflop']:.1f} GFLOP on the tensor cores (>= "
                        f"{entry['mma_bound_ms']:.4f} ms at 989 TFLOP/s), "
                        f"{entry['mma_tflops']:.1f} TFLOP/s")
                    results.setdefault(kname, {})[call] = entry


# memory-fusion resize (models/ocpg.py): the encoder's stride-16 and -32
# levels to stride 8, N = frames, 256 channels
FUSION_CALLS = (("serve", SERVE_N, ((24, 40), (12, 20)), (48, 80)),
                ("train", TRAIN_N, ((32, 40), (16, 20)), (64, 80)))


def resize_checks(results):
    """The memory-fusion bicubic resize (ops/image.py: two bf16 products
    with float32 accumulation, rounded to bf16 between them) on the card
    against the same function on the CPU, forward and gradient, within
    1e-2 x max |.| at the serving and train calls; then its device time at
    the train call, forward and forward + backward, beside F.interpolate's
    bicubic (the function the port called before, which rounds once)."""
    import torch.nn.functional as F

    def interpolate(x, size):
        return F.interpolate(x, size=size, mode="bicubic", align_corners=False)

    for name, n, levels, size in FUSION_CALLS:
        gen = torch.Generator().manual_seed(31)
        xs = [torch.randn(n, 256, h, w, generator=gen).bfloat16() for h, w in levels]
        gout = torch.randn(n, 256, *size, generator=gen)

        def fusion(inputs, resize=image.bicubic_resize):
            return sum(resize(x, size).float() for x in inputs)

        outs = {}
        for dev in ("cpu", "cuda"):
            inputs = [x.to(dev, copy=True).requires_grad_() for x in xs]
            out = fusion(inputs)
            out.backward(gout.to(dev))
            outs[dev] = [out.detach().cuda()] + [t.grad.cuda() for t in inputs]
        errs = [held(f"resize memory fusion {name} N={n} {levels}->{size} bf16 "
                     f"{'forward' if i == 0 else f'd_level{i}'} (card vs cpu)", a, b, 1e-2)
                for i, (a, b) in enumerate(zip(outs["cuda"], outs["cpu"]))]
        if name != "train":
            continue
        inputs = [x.cuda() for x in xs]
        grad_inputs = [x.cuda().requires_grad_() for x in xs]
        go = gout.cuda()

        def fwd_bwd(resize):
            torch.autograd.grad(fusion(grad_inputs, resize), grad_inputs, go)

        entry = dict(max_abs_err=max(errs),
                     fwd_ms=cuda_ms(lambda: fusion(inputs), 50),
                     interpolate_fwd_ms=cuda_ms(lambda: fusion(inputs, interpolate), 20),
                     fwd_bwd_ms=cuda_ms(lambda: fwd_bwd(image.bicubic_resize), 20),
                     interpolate_fwd_bwd_ms=cuda_ms(lambda: fwd_bwd(interpolate), 5, warmup=1))
        log(f"resize memory fusion {name} bf16: forward {entry['fwd_ms']:.4f} ms "
            f"(F.interpolate {entry['interpolate_fwd_ms']:.4f}), forward + backward "
            f"{entry['fwd_bwd_ms']:.4f} ms (F.interpolate "
            f"{entry['interpolate_fwd_bwd_ms']:.4f})")
        results["resize"] = entry


def swin_call(grid, heads, window=SWIN_WINDOW, frames=SWIN_T):
    """(bw, heads, n, SW-MSA mask) of the window attention of a shifted
    block at one stage of the serving clip (one clip, so nW = bw)."""
    dims = (frames,) + grid
    ws, ss = video_swin._get_window_size(dims, window, tuple(w // 2 for w in window))
    tp, hp, wp = (-(-d // w) * w for d, w in zip(dims, ws))
    mask = video_swin._sw_attn_mask(tp, hp, wp, ws, ss)
    return mask.shape[0], heads, ws[0] * ws[1] * ws[2], mask


def wattn_inputs(bw, heads, n, dtype, seed):
    """q (pre-scaled, contiguous), k and v (slices of one qkv tensor, as the
    Swin module hands them over) and a bias table gather's stand-in, all in
    dtype."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dh = SWIN_HEAD_DIM
    qkv = torch.randn(bw, n, 3, heads, dh, generator=g, device="cuda").to(dtype)
    bias = (torch.randn(heads, n, n, generator=g, device="cuda") * 0.5).to(dtype)
    return qkv[:, :, 0] * dh ** -0.5, qkv[:, :, 1], qkv[:, :, 2], bias


def wattn_work(q, mask):
    """(bytes, flops, L2 bytes) of one call: q, k, v, bias and the mask
    read once in the input's type, the output written once; the two
    products q.k^T and P.v (2 flops per multiply-add); and the bytes of bias
    and mask that the kernel reads from L2 (every (window, head) reads its
    n x n of each: the bias once per window, the mask once per head)."""
    bw, n, h, dh = q.shape
    es = q.element_size()
    nbytes = 4 * q.numel() * es + h * n * n * es
    if mask is not None:
        nbytes += mask.numel() * es
    l2_bytes = bw * h * n * n * es * (1 if mask is None else 2)
    return nbytes, 4 * bw * h * n * n * dh, l2_bytes


def wattn_held(got, want, scale, dtype):
    """(max |got - want|, within the limit, the limit): 1e-5 x scale for
    float32 inputs, 2e-2 + 2e-2 x |want| for bfloat16 ones."""
    err = (got - want).abs().max().item()
    if dtype == torch.float32:
        return err, err <= 1e-5 * scale, f"1e-5 x {scale:.3f}"
    excess = ((got - want).abs() - 2e-2 * want.abs()).max().item()
    return err, excess <= 2e-2, "2e-2 + 2e-2 x |out|"


def wattn_kernel_checks(results):
    """K7 at the four Video Swin-B serving calls (n = 245, dh = 32), the
    four Swin-B train calls (n = 147), a 2D Swin call (n = 49) and the
    kernel's edges (the largest window, n = 392, of an 8-frame clip; a small
    odd n = 13 with 2 heads), each with the shifted block's SW-MSA mask and
    without, against the plain version on the same values in float32:
    within 1e-5 x max |out| for float32 inputs, and within the 2e-2
    (absolute + relative) bound of tests/test_window_attention_pallas.py for
    bfloat16 ones; where n is not a multiple of 16 the rows of the last,
    ragged row tile are also held apart.  The mask is handed over in q's
    type, as the Swin module does.  Then the autograd Function's gradients
    (serving stages 0 and 3, train stage 0), and times."""
    import torch.nn.functional as F

    calls = [(f"swin-B stage {s}",) + swin_call(SWIN_GRIDS[s], SWIN_HEADS[s])
             for s in range(4)]
    calls += [(f"swin-B train stage {s}",)
              + swin_call(SWIN_TRAIN_GRIDS[s], SWIN_HEADS[s], frames=SWIN_TRAIN_T)
              for s in range(4)]
    check([c[1:4] for c in calls[4:8]] == [(bw, h, 147) for bw, h in
                                           zip(SWIN_TRAIN_WINDOWS, SWIN_HEADS)],
          f"Swin-B train calls {[c[1:4] for c in calls[4:8]]}")
    calls.append(("swin2d-B stage 1 (1 frame)",)
                 + swin_call((48, 80), 8, window=(1, 7, 7), frames=1))
    calls.append(("swin-B stage 1, 8 frames",)
                 + swin_call(SWIN_GRIDS[1], SWIN_HEADS[1], frames=8))
    calls.append(("odd window 1x1x13",) + swin_call((2, 26), 2, window=(1, 1, 13), frames=1))
    report = {}
    for name, bw, heads, n, mask_np in calls:
        for masked in (True, False):
            label = f"{name} bw={bw} h={heads} n={n}{' masked' if masked else ''}"
            for dtype in (torch.float32, torch.bfloat16):
                mask = torch.from_numpy(mask_np).cuda().to(dtype) if masked else None
                q, k, v, bias = wattn_inputs(bw, heads, n, dtype, seed=11)
                got = wattn.window_attention(q, k, v, bias, mask).float()
                torch.cuda.synchronize()
                want = wattn.window_attention_reference(q.float(), k.float(), v.float(),
                                                        bias.float(), mask)
                scale = want.abs().max().item()
                err, ok, limit = wattn_held(got, want, scale, dtype)
                check(math.isfinite(err) and ok,
                      f"K7 {label} {dtype}: max |kernel - plain| {err} (limit {limit})")
                tail = ""
                if n % 16:
                    # the rows of the last, ragged 16-row tile
                    t_err, t_ok, _ = wattn_held(got[:, n - n % 16:], want[:, n - n % 16:],
                                                scale, dtype)
                    check(math.isfinite(t_err) and t_ok,
                          f"K7 {label} {dtype}: rows {n - n % 16}..{n - 1} "
                          f"{t_err} (limit {limit})")
                    tail = f", last {n % 16} rows {t_err:.3e}"
                log(f"kernel wattn {label} {str(dtype)[6:]}: max_abs_err {err:.3e}{tail} "
                    f"(limit {limit})")
            # times in bf16, the serving type: the kernel alone (bias and
            # mask already in q's type), the plain version, and
            # scaled_dot_product_attention with bias + mask as its attn_mask,
            # built outside the timed calls
            qt, kt, vt = (t.permute(0, 2, 1, 3) for t in (q, k, v))
            attn_mask = bias[None].expand(bw, -1, -1, -1)
            if mask is not None:
                attn_mask = (attn_mask + mask[:, None]).contiguous()
            lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=attn_mask, scale=1.0)
            lib_err = ((lib.permute(0, 2, 1, 3).float() - want).abs()
                       - 2e-2 * want.abs()).max().item()
            check(lib_err <= 2e-2, f"K7 {label}: scaled_dot_product_attention disagrees "
                                   f"with the plain version ({lib_err})")
            ms, host_ms = cuda_times(lambda: wattn.window_attention(q, k, v, bias, mask), 20)
            plain_ms = cuda_ms(lambda: wattn.window_attention_reference(q, k, v, bias, mask), 5)
            library_ms, library_host_ms = cuda_times(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=attn_mask, scale=1.0), 20)
            nbytes, flops, l2_bytes = wattn_work(q, mask)
            bound_ms, bound_by = timed_bound(nbytes, flops, BF16_FLOPS_PER_S)
            tflops = flops / (ms * 1e-3) / 1e12
            log(f"kernel wattn {label} bf16: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
                f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP); {tflops:.2f} TFLOP/s; "
                f"bias + mask {l2_bytes / 1e6:.1f} MB from L2 = "
                f"{l2_bytes / (ms * 1e-3) / 1e12:.2f} TB/s; host enqueue per call "
                f"{host_ms:.4f} ms (sdpa {library_host_ms:.4f})")
            report[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                 bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                                 tflops=tflops, bias_mask_l2_mb=l2_bytes / 1e6,
                                 host_ms=host_ms, library_host_ms=library_host_ms)
            del q, k, v, bias, qt, kt, vt, attn_mask, lib, got, want

    # the Function's gradients (plain recompute, as the JAX custom VJP)
    # against autograd through the plain version, float32, with the mask
    for idx in (0, 3, 4):
        stage, bw, heads, n, mask_np = calls[idx]
        mask = torch.from_numpy(mask_np).cuda()
        gen = torch.Generator(device="cuda").manual_seed(12)
        qkv0 = torch.randn(bw, n, 3, heads, SWIN_HEAD_DIM, generator=gen, device="cuda")
        bias0 = torch.randn(heads, n, n, generator=gen, device="cuda") * 0.5
        gout = torch.randn(bw, n, heads, SWIN_HEAD_DIM, generator=gen, device="cuda")
        grads = []
        for fn in (wattn.window_attention, wattn.window_attention_reference):
            qkv, bias = qkv0.clone().requires_grad_(), bias0.clone().requires_grad_()
            out = fn(qkv[:, :, 0] * SWIN_HEAD_DIM ** -0.5, qkv[:, :, 1], qkv[:, :, 2],
                     bias, mask)
            out.backward(gout)
            grads.append((qkv.grad, bias.grad))
        for gname, a, b in zip(("d_qkv", "d_bias"), *grads):
            e, sc = (a - b).abs().max().item(), b.abs().max().item()
            check(math.isfinite(e) and e <= 1e-5 * sc,
                  f"K7 Function {gname} at {stage}: {e} > 1e-5 x {sc}")
            log(f"kernel wattn Function backward {stage} {gname}: max_abs_err "
                f"{e:.3e} (limit 1e-5 x {sc:.4g})")
    results["wattn"] = report[next(iter(report))]       # stage 0, masked
    results["wattn_train"] = next(v for k, v in report.items()
                                  if k.startswith("swin-B train stage 0"))
    results["wattn_report"] = report


# -------------------------------------------------------------------- card --
SMALL = OCPGConfig(backbone="resnet50", enc_layers=1, dec_layers=2, dim_feedforward=64,
                   num_queries=5, num_frames=2, compute_dtype="float32",
                   dataset_file="davis", text_layers=2, text_hidden=128, text_heads=4,
                   text_ffn=256, text_vocab=1000, text_max_pos=40)


def perturb(model, seed):
    """Seeded noise in every weight (running variances kept positive), so
    the sampling offsets and attention weights depend on the query."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            else:
                t.copy_(torch.randn(t.shape, generator=g) * 0.05)


def phase_card():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rng = np.random.default_rng(3)
        b, t, h, w, lt = 1, 2, 192, 256, 8
        samples = rng.standard_normal((b, t, h, w, 3)).astype(np.float32)
        smask = np.zeros((b, t, h, w), bool)
        smask[..., -32:] = True
        smask[..., -16:, :] = True
        ids = rng.integers(4, 999, (b, lt)).astype(np.int32)
        tmask = np.ones((b, lt), np.int32)
        ids[:, -2:], tmask[:, -2:] = 1, 0
        sizes = np.asarray([[h - 16, w - 32]], np.int32)
        inputs = [torch.from_numpy(a) for a in (samples, smask, ids, tmask, sizes)]
        # (backbone, branch, K7 launches: one per Swin block)
        for backbone, branch, k7 in (("resnet50", "davis", 0), ("resnet50", "a2d", 0),
                                     ("video_swin_test", "davis", 5)):
            cfg = SMALL.replace(backbone=backbone, dataset_file=branch)
            cpu_model = build_model(cfg, device="cpu")
            perturb(cpu_model, seed=2)
            gpu_model = copy.deepcopy(cpu_model).to("cuda")
            vidx = torch.tensor([1]) if branch == "a2d" else None
            want = cpu_model(*inputs, valid_indices=vidx)
            reset_counts()
            got = gpu_model(*(a.cuda() for a in inputs),
                            valid_indices=None if vidx is None else vidx.cuda())
            torch.cuda.synchronize()
            counts = read_counts()
            check(counts["K1"] == SMALL.enc_layers + SMALL.dec_layers and counts["K7"] == k7,
                  f"card {backbone} forward launched {counts}")
            label = f"{backbone} {branch}"
            keys = ["pred_logits", "pred_boxes"] + (["reference_points"]
                                                    if branch == "davis" else [])
            for k in keys:
                err = (got[k].cpu() - want[k]).abs().max().item()
                check(err <= 2e-3, f"{label} {k}: card vs cpu {err} > 2e-3")
                log(f"card {label} {k}: max |card - cpu| {err:.2e} (limit 2e-3)")
            scale = max(want["pred_masks"].abs().max().item(), 1e-3)
            err = (got["pred_masks"].cpu() - want["pred_masks"]).abs().max().item() / scale
            check(err <= 5e-3, f"{label} pred_masks: card vs cpu {err} > 5e-3 (scaled)")
            log(f"card {label} pred_masks: max |card - cpu| / max |mask| {err:.2e} "
                f"(limit 5e-3); launches {counts}")
        # (config, frames, K7 launches per step: one per Swin block in the
        # forward, again in the recompute)
        small = SMALL.replace(dataset_file="ytvos")
        swin = small.replace(backbone="video_swin_test")
        for cfg, frames, k7 in ((small, 2, 0), (swin, 2, 5),
                                (swin.replace(use_checkpoint=True), 2, 10),
                                (small.replace(pairwise_loss=True), 3, 0)):
            card_train_step(cfg, frames, k7)
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = False


def card_train_step(cfg, frames, k7):
    """The small model's train step (dropout and stochastic depth off) on
    the card against the CPU: matched queries identical, every loss and
    grad_norm within 1e-3 relative, K1 and K2 each launched once per
    transformer layer, K7 ``k7`` times."""
    label = (f"{cfg.backbone}{' use_checkpoint' if cfg.use_checkpoint else ''}"
             f"{' pairwise' if cfg.pairwise_loss else ''} T={frames}")
    batch = synthetic_batch(np.random.default_rng(5), batch=1, frames=frames, height=128,
                            width=192, text_len=8, vocab_size=cfg.text_vocab)
    cpu_model = build_model(cfg, device="cpu")
    perturb(cpu_model, seed=4)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    args = [torch.from_numpy(batch[k]) for k in ("samples", "samples_mask", "text_ids",
                                                 "text_mask")]
    args.append(torch.from_numpy(batch["targets"]["size"]))
    targets = {k: torch.from_numpy(v) for k, v in batch["targets"].items()}
    matched = []
    for model, dev in ((cpu_model, "cpu"), (gpu_model, "cuda")):
        with torch.no_grad():
            out = model(*(a.to(dev) for a in args),
                        targets={k: v.to(dev) for k, v in targets.items()}, train=True)
        matched.append(out["matched"].cpu())
    check(torch.equal(matched[0], matched[1]),
          f"card train {label} matched {matched[1].tolist()} != cpu {matched[0].tolist()}")
    metrics = []
    for model in (cpu_model, gpu_model):
        step = make_train_step(model, criterion_config(cfg), build_weight_dict(cfg),
                               build_optimizer(model, cfg), deterministic=True)
        reset_counts()
        metrics.append(step(batch))
    torch.cuda.synchronize()
    counts = read_counts()
    layers = cfg.enc_layers + cfg.dec_layers
    check(counts == counts_of(K1=layers, K2=layers, K7=k7),
          f"card train step {label} launched {counts} (want K1 and K2 {layers} times "
          f"each, K7 {k7})")
    want, got = metrics
    check(got.keys() == want.keys(), f"card train {label} metrics {sorted(got)}")
    worst = max(abs(got[k] - v) / max(abs(v), 1e-6) for k, v in want.items())
    for k, v in want.items():
        check(abs(got[k] - v) <= 1e-3 * max(abs(v), 1e-6),
              f"card train {label} {k}: card {got[k]} vs cpu {v} (limit 1e-3 relative)")
    log(f"card train step {label}: matched {matched[0].tolist()} on both; {len(want)} "
        f"metrics, max relative |card - cpu| {worst:.2e} (limit 1e-3); loss "
        f"{got['loss']:.4f}, grad_norm {got['grad_norm']:.4f}; launches {counts}")


# ------------------------------------------------------------------- serve --
def serve_path(results, name, cfg, k7_per_dispatch):
    """``cfg`` at full width behind ClipInferenceEngine, answering six uint8
    requests of mixed sizes at the 384 x 640 bucket, clip_len 5."""
    t0 = time.perf_counter()
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    log(f"{name}: built {cfg.backbone} + RoBERTa {cfg.text_layers}x{cfg.text_hidden}, "
        f"{cfg.enc_layers}+{cfg.dec_layers} layers, {cfg.compute_dtype}, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params "
        f"in {time.perf_counter() - t0:.1f} s")
    engine = ClipInferenceEngine(model, clip_len=5, buckets=((384, 640),))
    tok = SimpleTokenizer(max_len=16, vocab_size=cfg.text_vocab)
    rng = np.random.default_rng(1)
    shapes = [(5, 384, 640), (3, 360, 640), (5, 300, 500), (1, 384, 512),
              (4, 240, 320), (2, 384, 640)]
    captions = ["a man riding a horse", "the dog on the left", "a red car turning",
                "person in white shirt", "the cat jumping down", "a bird on a branch"]
    requests = []
    for (t, h, w), cap in zip(shapes, captions):
        ids, mask = tok([cap])
        requests.append(InferRequest(rng.integers(0, 256, (t, h, w, 3), dtype=np.uint8),
                                     ids[0], mask[0]))
    engine.run(requests[:2])                 # warm-up: cuDNN plans, kernel load
    torch.cuda.synchronize()

    done = []
    batches0 = engine.n_batches
    reset_counts()
    t0 = time.perf_counter()
    out = engine.run(requests, progress=lambda k: done.append(time.perf_counter() - t0))
    wall = time.perf_counter() - t0
    counts = read_counts()
    dispatches = engine.n_batches - batches0
    for r, o in zip(requests, out):
        check(o.shape == r.frames.shape[:3], f"answer {o.shape} for a {r.frames.shape} request")
        check(bool(np.isfinite(o).all()), "non-finite mask logits")
    want = counts_of(K1=8 * dispatches, K7=k7_per_dispatch * dispatches)
    check(counts == want, f"{name}: {dispatches} dispatches launched {counts}, want {want}")
    frames = sum(r.frames.shape[0] for r in requests)
    log(f"{name}: {len(requests)} requests, {frames} frames, {dispatches} dispatches, "
        f"launches {counts}, wall {wall:.3f} s, {frames / wall:.2f} frames/s")
    log(f"{name}: per-request completion latency (s): "
        + ", ".join(f"{x:.3f}" for x in done))
    results["paths"][name] = counts
    return profile_run(f"{name}: one dispatch ({requests[0].frames.shape[0]} frames, "
                       "canvas 384x640)", lambda: engine.run([requests[0]]))


def phase_serve(results):
    serve_path(results, "serve", ytvos_r101_boxsup(), 0)


def phase_swin_serve(results):
    prof = serve_path(results, "swin_serve", davis_videoswin_base(), SWIN_B_BLOCKS)
    if prof:
        k7 = prof["classes"].get("wattn", 0.0)
        log(f"swin_serve: K7 (wattn_fwd) {k7:.2f} ms = "
            f"{100 * k7 / prof['busy_ms']:.1f}% of a dispatch's device time; "
            f"K1 {prof['classes'].get('msda', 0.0):.2f} ms")


KERNEL_CLASSES = (   # (class, substrings of CUDA kernel names), first match wins
    ("memcpy", ("memcpy",)),
    ("wattn", ("wattn_fwd",)),
    ("msda_cm_bwd", ("msda_bwd_kernel",)),
    ("msda", ("msda_fwd_kernel", "msda_r4_kernel", "msda_fk_kernel")),
    ("fft", ("fft",)),
    ("conv", ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd", "cudnn")),
    ("gemm", ("gemm", "cutlass", "matmul", "sm90_xmma", "nvjet")),
    ("optimizer", ("multi_tensor", "foreach", "adam")),
    ("norm", ("norm",)),
    ("softmax", ("softmax",)),
    ("resize", ("upsample", "interp", "grid_sampler")),
    ("gather/scatter", ("gather", "scatter", "index")),
    ("copy/cast", ("copy", "cat", "transpose", "permute", "fill")),
    ("elementwise/reduce", ("elementwise", "reduce", "vectorized", "unrolled")),
)


def profile_run(label, fn):
    """fn() under torch.profiler: device busy share and device time by
    kernel class and by kernel.  Returns {"classes": device ms by class,
    "busy_ms": their sum, "wall_ms", "wattn_bwd_ms": the device ms of the
    kernels launched under K7's Function backward (its plain recompute)},
    or None when the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for ev in prof.key_averages():
        if ev.key.startswith(("Optimizer.", "ProfilerStep")):
            continue    # record_function ranges (Optimizer.step#AdamW.step) span kernels
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0 and str(getattr(ev, "device_type", "")).endswith("CUDA"):
            by_kernel[ev.key] = (dev_us / 1e3, ev.count)
    busy_ms = sum(ms for ms, _ in by_kernel.values())
    if not by_kernel:
        log("profile: torch.profiler recorded no device time (not measured)")
        return None
    classes = {}
    for name, (ms, _) in by_kernel.items():
        low = name.lower()
        cls = next((c for c, keys in KERNEL_CLASSES if any(k in low for k in keys)), "other")
        classes[cls] = classes.get(cls, 0.0) + ms
    launches = sum(n for _, n in by_kernel.values())
    log(f"profile: {label}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), {launches} kernel launches")
    log("profile: device ms by class: " + ", ".join(
        f"{c} {ms:.2f}" for c, ms in sorted(classes.items(), key=lambda kv: -kv[1])))
    for name, (ms, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"profile:   {ms:8.3f} ms  x{n:<5d} {name[:110]}")
    return {"classes": classes, "busy_ms": busy_ms, "wall_ms": wall_ms,
            "wattn_bwd_ms": device_ms_under(prof.events(), "WindowAttentionFunctionBackward")}


def device_ms_under(events, name_part):
    """Device ms of the kernels launched under the outermost CPU ranges
    whose name contains ``name_part`` (autograd's backward node of an
    autograd Function, whose nested backward runs inside it)."""
    def nested(ev):
        parent = ev.cpu_parent
        while parent is not None:
            if name_part in parent.name:
                return True
            parent = parent.cpu_parent
        return False

    us = 0.0
    for ev in events:
        if name_part in ev.name and not nested(ev):
            total = getattr(ev, "device_time_total", None)
            us += total if total is not None else getattr(ev, "cuda_time_total", 0)
    return us / 1e3


# --------------------------------------------------------------------- a2d --
def a2d_path(results, name, cfg, k7):
    """One A2D eval forward of ``cfg`` at full width on a 1 x 5 x 384 x 640
    clip with valid_indices, then its time over 5 forwards."""
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    batch = synthetic_batch(np.random.default_rng(0), batch=1, frames=5, height=384,
                            width=640)
    args = [torch.from_numpy(batch[k]).cuda() for k in
            ("samples", "samples_mask", "text_ids", "text_mask")]
    args.append(torch.from_numpy(batch["targets"]["size"]).cuda())
    vidx = torch.zeros(1, dtype=torch.int32, device="cuda")
    reset_counts()
    out = model(*args, valid_indices=vidx)
    torch.cuda.synchronize()
    counts = read_counts()
    want = counts_of(K1=cfg.enc_layers + cfg.dec_layers, K7=k7)
    check(counts == want, f"{name}: one forward launched {counts}, want {want}")
    results["paths"][name] = counts
    log(f"{name}: one {cfg.backbone} forward, launches {counts}")
    pm = out["pred_masks"]
    check(tuple(pm.shape) == (1, 1, 5, 384, 640), f"A2D pred_masks {tuple(pm.shape)}")
    check(bool(torch.isfinite(pm).all()), "A2D pred_masks not finite")
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        model(*args, valid_indices=vidx)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    log(f"{name}: eval forward 1x5x384x640 bf16 {dt * 1e3:.2f} ms, "
        f"{5 / dt:.2f} clip frames/s")


def phase_a2d(results):
    a2d_path(results, "a2d", a2d_r101_boxsup(), 0)


def phase_swin_a2d(results):
    # the JAX bench's Swin-B eval stage: the A2D config with the Swin-B backbone
    a2d_path(results, "swin_a2d", a2d_r101_boxsup().replace(backbone="video_swin_b_p4w7"),
             SWIN_B_BLOCKS)


# ------------------------------------------------------------------- train --
def compact_wire(batch, rng):
    """``batch`` in the compact wire of the JAX loader (``pad_to_canvas(
    compact=True)``): uint8 RGB frames, uint8 binary masks, float16 heatmaps."""
    out = dict(batch, samples=rng.integers(0, 256, batch["samples"].shape, dtype=np.uint8))
    tg = dict(batch["targets"])
    for k, dtype in (("masks", np.uint8), ("weights", np.float16), ("weak_masks", np.uint8)):
        tg[k] = tg[k].astype(dtype)
    out["targets"] = tg
    return out


def train_path(results, name, cfg, batch, k7):
    """The full-width train step of ``cfg`` (forward, matcher, losses,
    backward, clip, AdamW; dropout and stochastic depth on) on ``batch``:
    after a warm-up step, one step launches K1 and K2 once per transformer
    layer and K7 ``k7`` times, gives finite losses and grad norm, moves every
    trained group and leaves the frozen parameters bit-identical; then
    ms/step over 5 steps, peak memory, and one step under torch.profiler.
    Returns the profile (profile_run)."""
    t0 = time.perf_counter()
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    optimizer = build_optimizer(model, cfg)
    step = make_train_step(model, criterion_config(cfg), build_weight_dict(cfg), optimizer)
    log(f"{name}: built {cfg.backbone}{' (use_checkpoint)' if cfg.use_checkpoint else ''} "
        f"+ RoBERTa {cfg.text_layers}x{cfg.text_hidden}, {cfg.enc_layers}+{cfg.dec_layers} "
        f"layers, {cfg.compute_dtype} compute, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, "
        f"{sum(len(g['params']) for g in optimizer.adamw.param_groups)} trained tensors "
        f"in {time.perf_counter() - t0:.1f} s; batch samples {batch['samples'].dtype}, "
        f"heatmaps {batch['targets']['weights'].dtype}")
    step(batch)                              # warm-up: cuDNN plans, Adam state
    torch.cuda.synchronize()

    labels = {n: param_group_label(cfg, n) for n, _ in model.named_parameters()}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    reset_counts()
    metrics = step(batch)
    torch.cuda.synchronize()
    counts = read_counts()
    layers = cfg.enc_layers + cfg.dec_layers
    check(counts == counts_of(K1=layers, K2=layers, K7=k7),
          f"{name} step launched {counts} (want K1 and K2 {layers} times each, K7 {k7})")
    results["paths"][name] = counts
    bad = [k for k, v in metrics.items() if not math.isfinite(v)]
    check(not bad and metrics["finite"] == 1.0, f"{name} step: non-finite {bad}")
    moved = {}
    for n, p in model.named_parameters():
        same = torch.equal(p.detach(), before[n])
        if labels[n] == "frozen":
            check(same, f"{name}: frozen parameter {n} changed")
        else:
            n_moved, n_all = moved.get(labels[n], (0, 0))
            moved[labels[n]] = (n_moved + (not same), n_all + 1)
    check(all(m > 0 for m, _ in moved.values()), f"{name}: trained groups did not move: {moved}")
    frozen = sorted({n.split(".")[0] for n, g in labels.items() if g == "frozen"})
    del before
    log(f"{name}: one step, launches {counts}; loss {metrics['loss']:.4f}, grad_norm "
        f"{metrics['grad_norm']:.4f}, all {len(metrics)} metrics finite; tensors moved "
        "by group: " + ", ".join(f"{g} {m}/{a}" for g, (m, a) in sorted(moved.items()))
        + f"; frozen ones ({', '.join(frozen)}) bit-identical")

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = sum(times) / len(times)
    b, t, h, w = batch["samples"].shape[:4]
    log(f"{name}: B={b} T={t} {h}x{w} step {ms:.2f} ms mean over {len(times)} (min "
        f"{min(times):.2f}, max {max(times):.2f}; " + ", ".join(f"{x:.2f}" for x in times)
        + f"), peak memory {peak:.2f} GiB")
    prof = profile_run(f"{name}: one train step (B={b}, T={t}, {h}x{w})", lambda: step(batch))
    if prof:
        classes, total = prof["classes"], prof["busy_ms"]
        log(f"{name}: K2 (msda_cm_bwd) {classes.get('msda_cm_bwd', 0.0):.2f} ms = "
            f"{100 * classes.get('msda_cm_bwd', 0.0) / total:.1f}% of device time; "
            f"K1 {classes.get('msda', 0.0):.2f} ms")
    return prof


def phase_train(results):
    batch = synthetic_batch(np.random.default_rng(0), batch=1, frames=3, height=512,
                            width=640)
    train_path(results, "train", ytvos_r101_boxsup(), batch, 0)


def phase_swin_train(results):
    """The JAX bench's Swin-B train stage (``ytvos_r101_boxsup`` with the
    Video Swin-B backbone, B=1, T=3, 512x640, bf16), fed the compact wire:
    without per-block recompute (K7 once per block) and with it (twice)."""
    rng = np.random.default_rng(0)
    batch = compact_wire(synthetic_batch(rng, batch=1, frames=3, height=512, width=640), rng)
    cfg = ytvos_r101_boxsup().replace(backbone="video_swin_b_p4w7")
    for name, use_checkpoint in (("swin_train", False), ("swin_train_recompute", True)):
        prof = train_path(results, name, cfg.replace(use_checkpoint=use_checkpoint), batch,
                          SWIN_B_BLOCKS * (2 if use_checkpoint else 1))
        gc.collect()
        torch.cuda.empty_cache()
        if not prof:
            continue
        classes, total = prof["classes"], prof["busy_ms"]
        fwd, bwd = classes.get("wattn", 0.0), prof["wattn_bwd_ms"]
        log(f"{name}: K7 forward (wattn_fwd, forward and recompute) {fwd:.2f} ms = "
            f"{100 * fwd / total:.1f}%, K7 plain backward (the kernels under the "
            f"Function's backward: bmm, softmax and its backward, casts) {bwd:.2f} ms = "
            f"{100 * bwd / total:.1f}% of {total:.2f} device ms; copy/cast "
            f"{classes.get('copy/cast', 0.0):.2f}, norm {classes.get('norm', 0.0):.2f}, "
            f"gemm {classes.get('gemm', 0.0):.2f} ms")


# ------------------------------------------------------------------ resume --
def phase_resume(results):
    """Two train steps of the small model (dropout on), a save, a restore
    into a fresh model, optimizer and step: their state dicts and the
    generator state bit-identical to the saved ones; then one more step on
    each side, losses within 1e-3 relative (K2's float32 sums are atomic,
    so their order changes from run to run)."""
    cfg = SMALL.replace(dataset_file="ytvos")
    batches = [synthetic_batch(np.random.default_rng(20 + i), batch=1, frames=2, height=128,
                               width=192, text_len=8, vocab_size=cfg.text_vocab)
               for i in range(3)]

    def fresh(seed):
        model = build_model(cfg, generator=torch.Generator().manual_seed(seed))
        optimizer = build_optimizer(model, cfg)
        step = make_train_step(model, criterion_config(cfg), build_weight_dict(cfg),
                               optimizer)
        return {"model": model, "optimizer": optimizer, "train_step": step}

    directory = os.path.join(_build.BUILD_DIR, "resume_checkpoint")
    shutil.rmtree(directory, ignore_errors=True)
    reset_counts()
    run = fresh(0)
    for batch in batches[:2]:
        run["train_step"](batch)
    CheckpointManager(directory).save(2, run)
    resumed = fresh(1)
    restored = CheckpointManager(directory).restore()
    for name, obj in resumed.items():
        obj.load_state_dict(restored[name])
    for name in run:
        want = run[name].state_dict()
        same_tree(f"resume {name} (saved)", restored[name], want)
        same_tree(f"resume {name} (loaded)", resumed[name].state_dict(), want)
    count, at = resumed["optimizer"].count, resumed["train_step"].state["step"]
    want = run["train_step"](batches[2])
    got = resumed["train_step"](batches[2])
    torch.cuda.synchronize()
    counts = read_counts()
    layers = cfg.enc_layers + cfg.dec_layers
    check(counts == counts_of(K1=4 * layers, K2=4 * layers), f"resume launched {counts}")
    results["paths"]["resume"] = counts
    worst = max(abs(got[k] - v) / max(abs(v), 1e-6) for k, v in want.items())
    check(worst <= 1e-3, f"resume: the next step's metrics differ by {worst} relative")
    shutil.rmtree(directory)
    log(f"resume: 2 steps, save, restore into fresh objects: model, optimizer (AdamW "
        f"moments, count {count}), step counter {at} and generator state bit-identical; the "
        f"next step's {len(want)} metrics within {worst:.2e} relative (limit 1e-3); "
        f"launches {counts}")


# --------------------------------------------------------------- train_cli --
# the Ref-DAVIS tree of phase train_cli: one video of 8 frames at the native
# YTVOS size, one expression, full masks (the card has no h5py, so no
# Ref-YTVOS heatmaps; PERF.md section 4)
CLI_FRAMES, CLI_H, CLI_W = 8, 720, 1280


def palette_png(indices: np.ndarray) -> bytes:
    """A palette PNG of (H, W) uint8 indices (index i colored (i, i, i)),
    written with the standard library."""
    import struct
    import zlib

    h, w = indices.shape

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), indices], 1)   # filter 0
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0))
            + chunk(b"PLTE", np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes())
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def write_davis_tree(root):
    """Seeded JPEG frames (PIL) and palette-PNG masks of an object that
    moves across the frames, and the expression file."""
    from PIL import Image

    rng = np.random.default_rng(7)
    video, frames = "vid0", [f"{i:05d}" for i in range(CLI_FRAMES)]
    for sub in ("JPEGImages", "Annotations"):
        os.makedirs(os.path.join(root, "train", sub, video))
    base = np.kron(rng.random((CLI_H // 16, CLI_W // 16, 3)), np.ones((16, 16, 1)))
    yy, xx = np.mgrid[0:CLI_H, 0:CLI_W]
    for k, name in enumerate(frames):
        cy, cx = 360 + 10 * k, 420 + 60 * k
        obj = ((yy - cy) / 170.0) ** 2 + ((xx - cx) / 260.0) ** 2 <= 1.0
        img = 180 * base + 40 * rng.random((CLI_H, CLI_W, 3))
        img[obj] = 0.5 * img[obj] + [110, 20, 20]
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            os.path.join(root, "train", "JPEGImages", video, f"{name}.jpg"), quality=90)
        with open(os.path.join(root, "train", "Annotations", video, f"{name}.png"), "wb") as f:
            f.write(palette_png(obj.astype(np.uint8)))
    os.makedirs(os.path.join(root, "meta_expressions", "train"))
    with open(os.path.join(root, "meta_expressions", "train", "meta_expressions.json"),
              "w") as f:
        json.dump({"videos": {video: {"frames": frames, "expressions": {
            "0": {"exp": "the red blob moving to the right", "obj_id": "1"}}}}}, f)


def pinned_copy_ms(batch):
    """Device ms of one compact batch's host-to-device copy from pinned
    memory (cuda_times), and its bytes."""
    from ocpg_tpu_torch.parallel.mesh import _map_arrays, _tensors

    pinned = _map_arrays(batch, lambda x: torch.as_tensor(x).pin_memory())
    nbytes = sum(t.numel() * t.element_size() for t in _tensors(pinned))
    ms, _ = cuda_times(lambda: _map_arrays(pinned, lambda t: t.to("cuda", non_blocking=True)),
                       iters=20)
    return ms, nbytes


def phase_train_cli(results):
    """The port's train CLI in this process, as a user runs it: the
    full-width ytvos_r101_boxsup model (ResNet-101, bf16, canvas 512 x 640,
    B=1, T=3) on a seeded Ref-DAVIS tree of 720 x 1280 frames, one epoch,
    then --resume for a second.  K1 and K2 8 times a step over every step of
    both runs, K3-K7 never; every logged loss finite; log.txt with epochs 0
    and 1; the latest checkpoint at 2 x steps per epoch; the frozen ResNet
    stem and text encoder of the resumed model bit-identical to their init.
    Also the loader alone (batches/s with its worker count and the host's
    cores) and one compact batch's pinned copy."""
    from ocpg_tpu_torch.cli import train as train_cli
    from ocpg_tpu_torch.data.imageio import decoder

    gc.collect()
    torch.cuda.empty_cache()
    smi = nvidia_smi_line()
    root = tempfile.mkdtemp(prefix="train_cli_", dir=_build.BUILD_DIR)
    try:
        tree, out = os.path.join(root, "davis"), os.path.join(root, "run")
        t0 = time.perf_counter()
        write_davis_tree(tree)
        argv = ["--dataset_file", "davis", "--davis_path", tree, "--backbone", "resnet101",
                "--supervision", "box", "--num_frames", "3", "--batch_size", "1",
                "--output_dir", out, "--log_every", "1", "--tb_every", "0",
                "--debug_images_every", "0"]
        args = train_cli.get_args(argv + ["--epochs", "1"])
        cfg = train_cli.make_config(args)
        width = [f.name for f in dataclasses.fields(cfg)
                 if f.name not in ("dataset_file", "epochs")]
        check(all(getattr(cfg, k) == getattr(ytvos_r101_boxsup(), k) for k in width),
              "train_cli: the CLI's config is not ytvos_r101_boxsup at full width")
        dataset = train_cli.make_dataset(args, cfg)
        loader = train_cli.make_loader(args, cfg, dataset)
        steps = len(dataset) // cfg.batch_size
        log(f"train_cli: Ref-DAVIS tree, {CLI_FRAMES} frames at {CLI_H}x{CLI_W}, "
            f"{len(dataset)} clips, written in {time.perf_counter() - t0:.1f} s; decode "
            f"{decoder()}")

        # the loader alone: decode, transform and batch at 720p
        t0 = time.perf_counter()
        n = sum(1 for _ in loader.epoch(0)) + sum(1 for _ in loader.epoch(1))
        secs = time.perf_counter() - t0
        first = next(iter(loader.epoch(0)))
        copy_ms, nbytes = pinned_copy_ms(first)
        log(f"train_cli: loader alone {n} batches in {secs:.3f} s = {n / secs:.2f} "
            f"batches/s, {loader.num_workers} worker threads on {os.cpu_count()} host "
            f"cores [{smi}]")
        log(f"train_cli: compact batch ({nbytes / 2**20:.2f} MiB) pinned host-to-device "
            f"copy {copy_ms:.4f} device ms = {nbytes / copy_ms / 1e6:.2f} GB/s [{smi}]")

        paths = {}
        torch.cuda.reset_peak_memory_stats()
        for run, extra in (("first", ["--epochs", "1"]),
                           ("resumed", ["--epochs", "2", "--resume",
                                        os.path.join(out, "checkpoints")])):
            reset_counts()
            t0 = time.perf_counter()
            train_cli.main(argv + extra)
            torch.cuda.synchronize()
            counts = read_counts()
            check(counts == counts_of(K1=8 * steps, K2=8 * steps),
                  f"train_cli {run} run of {steps} steps launched {counts} (want K1 and K2 "
                  f"8 per step)")
            check("cv2" not in sys.modules, "train_cli: the train path imported cv2")
            paths[run] = counts
            log(f"train_cli: {run} run, {steps} steps in {time.perf_counter() - t0:.1f} s "
                f"(model build, loader and checkpoint included), launches {counts} [{smi}]")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        results["paths"]["train_cli"] = {k: paths["first"][k] + paths["resumed"][k]
                                         for k in paths["first"]}

        with open(os.path.join(out, "log.txt")) as f:
            lines = [json.loads(line) for line in f if line.strip()]
        check([r["epoch"] for r in lines] == [0, 1], f"train_cli log.txt epochs {lines}")
        for r in lines:
            check(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]),
                  f"train_cli epoch {r['epoch']}: non-finite logged loss {r}")
        latest = CheckpointManager(os.path.join(out, "checkpoints")).latest_step()
        check(latest == 2 * steps, f"train_cli latest checkpoint {latest} != {2 * steps}")
        saved = CheckpointManager(os.path.join(out, "checkpoints")).restore()["model"]
        init = build_model(cfg, device="cpu").state_dict()
        frozen = [k for k in init if k.startswith("text_encoder.") or (
            k.startswith("backbone.") and param_group_label(cfg, k) == "frozen")]
        changed = [k for k in frozen if not torch.equal(saved[k], init[k])]
        check(frozen and not changed, f"train_cli: frozen tensors changed: {changed[:5]}")
        moved = sum(not torch.equal(saved[k], init[k]) for k in init if k not in frozen)
        check(moved > 0, "train_cli: no trained tensor moved")
        for r in lines:
            per_step = r["data_time_s"] + r["step_time_s"]
            log(f"train_cli: epoch {r['epoch']}: {1 / per_step:.3f} steps/s over the loop "
                f"(data_time_s {r['data_time_s']:.4f} = {100 * r['data_time_s'] / per_step:.1f}%"
                f", step_time_s {r['step_time_s']:.4f}), epoch time_s {r['time_s']:.2f} "
                f"with its checkpoint; mean loss {r['loss']:.4f} [{smi}]")
        log(f"train_cli: peak memory {peak:.2f} GiB over both runs; {len(frozen)} frozen "
            f"tensors (ResNet stem and layer1, text encoder) bit-identical to the init after "
            f"the resume, {moved} others moved; latest checkpoint step {latest} [{smi}]")
        results["train_cli"] = {"steps_per_epoch": steps, "peak_gib": peak,
                                "loader_batches_per_s": n / secs, "pinned_copy_ms": copy_ms}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def same_tree(label, got, want):
    """Tensors equal in type and bits, other leaves equal, keys equal."""
    if isinstance(want, torch.Tensor):
        check(isinstance(got, torch.Tensor) and got.dtype == want.dtype
              and torch.equal(got.cpu(), want.cpu()), f"{label}: tensors differ")
    elif isinstance(want, dict):
        check(isinstance(got, dict) and got.keys() == want.keys(), f"{label}: keys differ")
        for k in want:
            same_tree(f"{label}/{k}", got[k], want[k])
    elif isinstance(want, (list, tuple)):
        check(len(got) == len(want), f"{label}: lengths differ")
        for i, (g, w) in enumerate(zip(got, want)):
            same_tree(f"{label}/{i}", g, w)
    else:
        check(got == want, f"{label}: {got!r} != {want!r}")


# ------------------------------------------------------------------ std_op --
def phase_std_op(results):
    """The standard-layout op once, forward and backward, at the train
    encoder call (bf16 value, msda_inputs in the standard layout)."""
    lq = sum(h * w for h, w in TRAIN_SHAPES)
    value, x, y, aw = msda_inputs(TRAIN_SHAPES, TRAIN_N, lq, torch.bfloat16, seed=21)
    inputs = [t.requires_grad_() for t in (value, *msda._cm_to_standard(x, y, aw))]
    reset_counts()
    out = msda.ms_deform_attn_fast(inputs[0], TRAIN_SHAPES, *inputs[1:])
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts == counts_of(K3=1, K4=1), f"std_op launched {counts}")
    check(tuple(out.shape) == (TRAIN_N, lq, HEADS * HEAD_DIM) and bool(torch.isfinite(out).all()),
          f"std_op output {tuple(out.shape)} not finite or of the wrong shape")
    for t in inputs:
        check(t.grad is not None and t.grad.shape == t.shape
              and bool(torch.isfinite(t.grad).all()), "std_op gradient missing or not finite")
    results["paths"]["std_op"] = counts
    log(f"std_op: ms_deform_attn_fast forward + backward at the train encoder call, "
        f"launches {counts}, output and gradients finite")


# -------------------------------------------------------------- msda_bench --
def phase_msda_bench(results):
    """The port's MSDA kernel bench, in this process, as a user runs it."""
    argv = ["--variants", "cm", "r4", "fk", "sep", "--bwd", "--shapes", "eval",
            "--check", "sep"]
    reset_counts()
    out = bench_msda_kernel.main(argv)
    torch.cuda.synchronize()
    counts = read_counts()
    check(all(counts[k] >= 1 for k in ("K1", "K2", "K5", "K6"))
          and counts["K3"] == counts["K4"] == counts["K7"] == 0,
          f"msda_bench launched {counts}")
    check(sorted(out["check"]) == ["cm", "fk", "r4", "sep"]
          and all(e < 2e-2 for e in out["check"].values()),
          f"msda_bench checks {out['check']}")
    results["paths"]["msda_bench"] = counts
    results["msda_bench"] = out
    log(f"msda_bench: {bench_msda_kernel.__name__} {' '.join(argv)}: launches {counts}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU", file=sys.stderr)
        return 2
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}")
    results = {"paths": {}}

    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"build: {len(_build.SOURCES)} kernel source(s) in {secs:.1f} s "
        f"(phase {time.perf_counter() - t0:.1f} s)")
    for src, text in _build.build_logs.items():
        log(f"build log {src}:\n{text.strip()}")
    for name, fn in (("kernel", phase_kernel), ("card", lambda _: phase_card()),
                     ("serve", phase_serve), ("a2d", phase_a2d), ("train", phase_train),
                     ("swin_serve", phase_swin_serve), ("swin_a2d", phase_swin_a2d),
                     ("swin_train", phase_swin_train), ("resume", phase_resume),
                     ("train_cli", phase_train_cli), ("std_op", phase_std_op),
                     ("msda_bench", phase_msda_bench)):
        t0 = time.perf_counter()
        fn(results)
        log(f"phase {name} ok in {time.perf_counter() - t0:.1f} s")

    # K1 timed at the serving encoder call (and at every call of phase
    # kernel, by_call), K2, K3 and K4 at the train encoder (K2 and K4 also at
    # the serving encoder, the decoder calls and on clustered samples), K5 and K6 at the
    # serving encoder (the bench's eval call, and the train one), K7 at the
    # Swin-B train stage-0 call of a shifted block (the serving one beside
    # it); launches counted on each path's run, the entry's own on its main
    # path (train for K1 and K2, std_op for K3 and K4, msda_bench for K5 and
    # K6, swin_train for K7)
    def entry(name, source, replaces, k, counter, main_path, **extra):
        by_path = {path: counts[counter] for path, counts in results["paths"].items()}
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": by_path[main_path], "launches_by_path": by_path,
                "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
                "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                "library_ms": k.get("library_ms"), **extra}

    kernels = [
        entry("ms_deform_attn_cm", "ocpg_tpu_torch/ops/csrc/ms_deform_attn_fwd.cu",
              "ocpg_tpu/ops/ms_deform_attn_pallas.py:620", results["msda"], "K1", "train",
              at="serve encoder",
              train_encoder={k: results["msda_train"][k] for k in
                             ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")},
              by_call=results["msda_calls"]),
        entry("ms_deform_attn_cm_backward", "ocpg_tpu_torch/ops/csrc/ms_deform_attn_bwd.cu",
              "ocpg_tpu/ops/ms_deform_attn_pallas.py:994", results["msda_bwd"], "K2", "train",
              at="train encoder", by_call=results["msda_bwd_calls"]),
        entry("ms_deform_attn_fast", "ocpg_tpu_torch/ops/csrc/ms_deform_attn_fwd.cu",
              "ocpg_tpu/ops/ms_deform_attn_pallas.py:138", results["K3"]["train encoder"],
              "K3", "std_op", at="train encoder",
              serve_encoder=results["K3"]["serve encoder"]),
        entry("ms_deform_attn_backward", "ocpg_tpu_torch/ops/csrc/ms_deform_attn_bwd.cu",
              "ocpg_tpu/ops/ms_deform_attn_pallas.py:370", results["K4"]["train encoder"],
              "K4", "std_op", at="train encoder", by_call=results["K4"]),
        entry("ms_deform_attn_cm_r4", "ocpg_tpu_torch/ops/csrc/ms_deform_attn_r4.cu",
              "ocpg_tpu/ops/ms_deform_attn_pallas.py:746", results["K5"]["serve encoder"],
              "K5", "msda_bench", at="serve encoder",
              **{k: results["K5"]["serve encoder"][k]
                 for k in ("mma_gflop", "mma_bound_ms", "mma_tflops")},
              by_call=results["K5"], bench_ms=results["msda_bench"]["ms"]["fwd/r4/eval"]),
        entry("ms_deform_attn_cm_fk", "ocpg_tpu_torch/ops/csrc/ms_deform_attn_fk.cu",
              "ocpg_tpu/ops/ms_deform_attn_pallas.py:1159", results["K6"]["serve encoder"],
              "K6", "msda_bench", at="serve encoder",
              **{k: results["K6"]["serve encoder"][k]
                 for k in ("mma_gflop", "mma_bound_ms", "mma_tflops")},
              by_call=results["K6"], bench_ms=results["msda_bench"]["ms"]["fwd/fk/eval"]),
        entry("window_attention", "ocpg_tpu_torch/ops/csrc/window_attention_fwd.cu",
              "ocpg_tpu/ops/window_attention_pallas.py:139", results["wattn_train"], "K7",
              "swin_train",
              at="swin-B train stage 0, shifted block (bw=437, h=4, n=147, dh=32)",
              serve_stage0=dict(results["wattn"], at="swin-B serving stage 0, shifted block "
                                                     "(bw=322, h=4, n=245, dh=32)"),
              by_call=results["wattn_report"]),
    ]
    log("resize: " + json.dumps(results["resize"]))
    print(nvidia_smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
