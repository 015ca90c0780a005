#!/usr/bin/env python3
"""Drive the PyTorch port (``ocpg_tpu_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

It takes no arguments and runs every phase; each fails the run (non-zero
exit, no result line) if it goes wrong:

1. build   -- compile every CUDA kernel of the port from ocpg_tpu_torch/ops/csrc
              (one nvcc per source, all started together).
2. kernel  -- each kernel against its plain PyTorch version on the card, in
              float32 and bfloat16, with samples outside the map, on integer
              pixel coordinates (xp = -1 among them) and at NaN/inf
              coordinates: the MSDA forward (K1) at the serving, A2D and train
              calls, its backward (K2) at the train calls against autograd
              through the plain version; each kernel's time, the plain
              version's and the bound.
3. card    -- the small model on the card (through the kernels) against the
              same weights on the CPU (through the plain versions), TF32 off:
              the eval forward at the bounds of tests/test_golden_parity.py,
              and one train step with dropout off (matched queries identical,
              every loss and grad_norm within 1e-3 relative, K1 and K2 each
              launched once per transformer layer).
4. serve   -- the full-width YTVOS R101 model (ResNet-101, RoBERTa-base,
              4+4 layers, bf16) behind ClipInferenceEngine, answering uint8
              requests of mixed sizes; every answer has its request's shape
              and is finite, MSDA launched 8 times per dispatch and its
              backward never.
5. a2d     -- the A2D R101 eval forward on one 5 x 384 x 640 clip (bf16,
              valid_indices): finite masks of shape (1, 1, 5, 384, 640),
              MSDA launched 8 times in the forward and its backward never.
6. train   -- the full-width YTVOS R101 train step (forward, matcher, the
              weak-supervision losses, backward, clip, AdamW; bf16 with
              float32 parameters, dropout on) on one 3 x 512 x 640 clip: K1
              and K2 each launched 8 times in a step, every loss and the
              grad norm finite, the trained parameters moved and the frozen
              ones (ResNet stem and layer1, text encoder) bit-identical;
              then ms/step over 5 steps, peak memory, and one step under
              torch.profiler.

The launch counts of the serve, a2d and train phases are each reset just
before that phase's path runs and read just after.

It imports nothing of JAX.  The last three lines of its output are the
card's name and power limit (nvidia-smi), one JSON object listing the
kernels, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from ocpg_tpu_torch.config import OCPGConfig, a2d_r101_boxsup, ytvos_r101_boxsup
from ocpg_tpu_torch.data.synthetic import synthetic_batch
from ocpg_tpu_torch.engine.infer import ClipInferenceEngine, InferRequest
from ocpg_tpu_torch.engine.optim import build_optimizer, param_group_label
from ocpg_tpu_torch.engine.train import make_train_step
from ocpg_tpu_torch.models.build import build_model, build_weight_dict, criterion_config
from ocpg_tpu_torch.models.text_encoder import SimpleTokenizer
from ocpg_tpu_torch.ops import _build
from ocpg_tpu_torch.ops import ms_deform_attn as msda

# H100 SXM (NVIDIA's data sheet): HBM rate and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# serving path: bucket 384 x 640, clip_len 5, one slot -> levels at strides 8..64
SERVE_SHAPES = ((48, 80), (24, 40), (12, 20), (6, 10))
SERVE_N, HEADS, HEAD_DIM, POINTS, QUERIES = 5, 8, 32, 4, 5
# train path: B=1 clip of T=3 frames at 512 x 640 -> levels at strides 8..64
TRAIN_SHAPES = ((64, 80), (32, 40), (16, 20), (8, 10))
TRAIN_N = 3


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


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over iters launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ kernel --
def msda_inputs(shapes, n, lq, dtype, seed):
    """MSDA inputs on the card: locations in [-0.1, 1.1] (some outside the
    map), a quarter of the points on integer pixel coordinates, and some
    samples at NaN or inf coordinates (a wholly padded frame has valid ratio
    0, so the serving path gives the kernel NaN reference points)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    s = sum(h * w for h, w in shapes)
    l = len(shapes)
    dev = "cuda"
    value = torch.randn(n, s, HEADS, HEAD_DIM, generator=g, device=dev).to(dtype)
    x = torch.rand(n, HEADS, l, POINTS, lq, generator=g, device=dev) * 1.2 - 0.1
    y = torch.rand(n, HEADS, l, POINTS, lq, generator=g, device=dev) * 1.2 - 0.1
    for lid, (h, w) in enumerate(shapes):
        kx = torch.randint(-1, w + 1, (n, HEADS, lq), generator=g, device=dev)
        ky = torch.randint(-1, h + 1, (n, HEADS, lq), generator=g, device=dev)
        x[:, :, lid, 0] = (kx + 0.5) / w
        y[:, :, lid, 0] = (ky + 0.5) / h
    x[:, :, :, 1, ::7] = float("nan")
    y[:, :, -1, 2, 3::11] = float("inf")
    aw = torch.softmax(torch.randn(n, HEADS, l * POINTS, lq, generator=g, device=dev), 2)
    return value, x.contiguous(), y.contiguous(), aw.reshape(x.shape).contiguous()


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


def timed_bound(nbytes, flops):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def phase_kernel(results):
    """K1 at the calls the main paths make: the serving encoder and decoder
    (N = clip_len frames), the A2D ones (valid_indices leaves N = 1) and the
    train ones (N = B x T = 3 frames at 512 x 640); K2 at the train calls."""
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
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            value, x, y, aw = msda_inputs(shapes, n, lq, dtype, seed=7)
            got = msda.ms_deform_attn_cm(value, shapes, x, y, aw)
            torch.cuda.synchronize()
            want = msda.ms_deform_attn_cm_reference(value.float(), shapes, x, y, aw)
            check(bool(torch.isfinite(want).all()), f"MSDA {name}: plain version not finite")
            err = (got.float() - want).abs().max().item()
            scale = want.abs().max().item()
            check(math.isfinite(err) and err <= tol * scale,
                  f"MSDA {name} {dtype}: max |kernel - plain| {err} > "
                  f"{tol} x max |out| {scale}")
            log(f"kernel msda {name} N={n} Lq={lq} {str(dtype)[6:]}: max_abs_err "
                f"{err:.3e} (limit {tol} x {scale:.3f})")
            if dtype == torch.bfloat16:
                ms = cuda_ms(lambda: msda.ms_deform_attn_cm(value, shapes, x, y, aw), 50)
                plain_ms = cuda_ms(lambda: msda.ms_deform_attn_cm_reference(
                    value, shapes, x, y, aw), 10)
                nbytes, flops = msda_work(shapes, value, x, y, aw)
                bound_ms, bound_by = timed_bound(nbytes, flops)
                gather_bytes = x.numel() * 4 * HEAD_DIM * value.element_size()
                log(f"kernel msda {name} bf16: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB, "
                    f"{flops / 1e9:.3f} GFLOP f32); corner gathers "
                    f"{gather_bytes / 1e9:.3f} GB = "
                    f"{gather_bytes / (ms * 1e-3) / 1e12:.2f} TB/s through L2/L1")
                report[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                    bound_by=bound_by, max_abs_err=err)
            if not name.startswith("train"):
                continue
            # K2 at the same call: each gradient against autograd through
            # the plain version, within tol x its own max |.|.  The order of
            # d_value's atomic sums changes from run to run.
            g = torch.randn(n, lq, HEADS * HEAD_DIM, generator=torch.Generator(
                device="cuda").manual_seed(9), device="cuda").to(dtype)
            got = msda.ms_deform_attn_cm_backward(value, shapes, x, y, aw, g)
            torch.cuda.synchronize()
            want = msda.ms_deform_attn_cm_grad_reference(value.float(), shapes, x, y, aw,
                                                         g.float())
            errs = []
            for gname, a, b in zip(("d_value", "d_x", "d_y", "d_aw"), got, want):
                check(a.dtype == (dtype if gname == "d_value" else torch.float32),
                      f"K2 {gname} dtype {a.dtype}")
                check(bool(torch.isfinite(b).all()), f"K2 {name}: plain {gname} not finite")
                e = (a.float() - b).abs().max().item()
                sc = b.abs().max().item()
                check(math.isfinite(e) and e <= tol * sc,
                      f"K2 {name} {dtype} {gname}: max |kernel - plain| {e} > "
                      f"{tol} x max |grad| {sc}")
                errs.append(e)
                log(f"kernel msda_bwd {name} N={n} Lq={lq} {str(dtype)[6:]} {gname}: "
                    f"max_abs_err {e:.3e} (limit {tol} x {sc:.4g})")
            if dtype == torch.bfloat16:
                ms = cuda_ms(lambda: msda.ms_deform_attn_cm_backward(
                    value, shapes, x, y, aw, g), 20)
                # the plain backward alone: autograd through a graph of the
                # plain forward built once, outside the timed calls
                inputs = [t.detach().requires_grad_() for t in (value, x, y, aw)]
                with torch.enable_grad():
                    out = msda.ms_deform_attn_cm_reference(inputs[0], shapes, *inputs[1:])
                plain_ms = cuda_ms(lambda: torch.autograd.grad(out, inputs, g,
                                                               retain_graph=True), 5)
                del inputs, out
                nbytes, flops = msda_bwd_work(shapes, value, x, y, aw)
                bound_ms, bound_by = timed_bound(nbytes, flops)
                log(f"kernel msda_bwd {name} bf16: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB, "
                    f"{flops / 1e9:.3f} GFLOP f32)")
                report[f"bwd {name}"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                             bound_by=bound_by, max_abs_err=max(errs))
    results["msda"] = report["serve encoder"]
    results["msda_train"] = report["train encoder"]
    results["msda_bwd"] = report["bwd train encoder"]


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
        for branch in ("davis", "a2d"):
            cpu_model = build_model(SMALL.replace(dataset_file=branch), device="cpu")
            perturb(cpu_model, seed=2)
            gpu_model = copy.deepcopy(cpu_model).to("cuda")
            vidx = torch.tensor([1]) if branch == "a2d" else None
            want = cpu_model(*inputs, valid_indices=vidx)
            msda.launches = 0
            got = gpu_model(*(a.cuda() for a in inputs),
                            valid_indices=None if vidx is None else vidx.cuda())
            torch.cuda.synchronize()
            check(msda.launches == SMALL.enc_layers + SMALL.dec_layers,
                  f"card forward launched MSDA {msda.launches} times")
            keys = ["pred_logits", "pred_boxes"] + (["reference_points"]
                                                    if branch == "davis" else [])
            for k in keys:
                err = (got[k].cpu() - want[k]).abs().max().item()
                check(err <= 2e-3, f"{branch} {k}: card vs cpu {err} > 2e-3")
                log(f"card {branch} {k}: max |card - cpu| {err:.2e} (limit 2e-3)")
            scale = max(want["pred_masks"].abs().max().item(), 1e-3)
            err = (got["pred_masks"].cpu() - want["pred_masks"]).abs().max().item() / scale
            check(err <= 5e-3, f"{branch} pred_masks: card vs cpu {err} > 5e-3 (scaled)")
            log(f"card {branch} pred_masks: max |card - cpu| / max |mask| {err:.2e} "
                "(limit 5e-3)")
        card_train_step()
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = False


def card_train_step():
    """The small model's train step (dropout off) on the card against the
    CPU: matched queries identical, every loss and grad_norm within 1e-3
    relative, K1 and K2 each launched once per transformer layer."""
    cfg = SMALL.replace(dataset_file="ytvos")
    batch = synthetic_batch(np.random.default_rng(5), batch=1, frames=2, height=128,
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
          f"card train matched {matched[1].tolist()} != cpu {matched[0].tolist()}")
    metrics = []
    for model in (cpu_model, gpu_model):
        step = make_train_step(model, criterion_config(cfg), build_weight_dict(cfg),
                               build_optimizer(model, cfg), deterministic=True)
        msda.launches = msda.bwd_launches = 0
        metrics.append(step(batch))
    torch.cuda.synchronize()
    layers = cfg.enc_layers + cfg.dec_layers
    check(msda.launches == layers and msda.bwd_launches == layers,
          f"card train step launched K1 {msda.launches}, K2 {msda.bwd_launches} times "
          f"(want {layers} each)")
    want, got = metrics
    worst = max(abs(got[k] - v) / max(abs(v), 1e-6) for k, v in want.items())
    for k, v in want.items():
        check(abs(got[k] - v) <= 1e-3 * max(abs(v), 1e-6),
              f"card train {k}: card {got[k]} vs cpu {v} (limit 1e-3 relative)")
    log(f"card train step: matched {matched[0].tolist()} on both; {len(want)} metrics, "
        f"max relative |card - cpu| {worst:.2e} (limit 1e-3); loss {got['loss']:.4f}, "
        f"grad_norm {got['grad_norm']:.4f}; K1 x{layers}, K2 x{layers}")


# ------------------------------------------------------------------- serve --
def phase_serve(results):
    cfg = ytvos_r101_boxsup()
    t0 = time.perf_counter()
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    log(f"serve: built {cfg.backbone} + RoBERTa {cfg.text_layers}x{cfg.text_hidden}, "
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
    msda.launches = msda.bwd_launches = 0
    batches0 = engine.n_batches
    t0 = time.perf_counter()
    out = engine.run(requests, progress=lambda k: done.append(time.perf_counter() - t0))
    wall = time.perf_counter() - t0
    launches, bwd = msda.launches, msda.bwd_launches
    dispatches = engine.n_batches - batches0
    for r, o in zip(requests, out):
        check(o.shape == r.frames.shape[:3], f"answer {o.shape} for a {r.frames.shape} request")
        check(bool(np.isfinite(o).all()), "non-finite mask logits")
    check(launches == 8 * dispatches,
          f"MSDA launched {launches} times in {dispatches} dispatches (want 8 each)")
    check(bwd == 0, f"serving launched the MSDA backward {bwd} times (want 0)")
    frames = sum(r.frames.shape[0] for r in requests)
    log(f"serve: {len(requests)} requests, {frames} frames, {dispatches} dispatches, "
        f"{launches} MSDA launches, wall {wall:.3f} s, {frames / wall:.2f} frames/s")
    log("serve: per-request completion latency (s): "
        + ", ".join(f"{x:.3f}" for x in done))
    results["launches"]["serve"] = launches
    results["bwd_launches"]["serve"] = bwd
    profile_dispatch(engine, requests[0])


KERNEL_CLASSES = (   # (class, substrings of CUDA kernel names), first match wins
    ("msda_cm_bwd", ("msda_cm_bwd",)),
    ("msda", ("msda_cm_fwd",)),
    ("fft", ("fft",)),
    ("conv", ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd", "cudnn")),
    ("gemm", ("gemm", "cutlass", "matmul", "sm90_xmma")),
    ("optimizer", ("multi_tensor", "foreach", "adam")),
    ("norm", ("norm",)),
    ("softmax", ("softmax",)),
    ("resize", ("upsample", "interp", "grid_sampler")),
    ("gather/scatter", ("gather", "scatter", "index")),
    ("copy/cast", ("copy", "cat", "transpose", "permute", "fill")),
    ("elementwise/reduce", ("elementwise", "reduce", "vectorized", "unrolled")),
)


def profile_dispatch(engine, request):
    """One serving dispatch under torch.profiler."""
    profile_run(f"one dispatch ({request.frames.shape[0]} frames, canvas 384x640)",
                lambda: engine.run([request]))


def profile_run(label, fn):
    """fn() under torch.profiler: device busy share and device time by
    kernel class and by kernel; returns the class times (ms), or None when
    the profiler recorded no device time."""
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
    return classes


# --------------------------------------------------------------------- a2d --
def phase_a2d(results):
    cfg = a2d_r101_boxsup()
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    batch = synthetic_batch(np.random.default_rng(0), batch=1, frames=5, height=384,
                            width=640)
    args = [torch.from_numpy(batch[k]).cuda() for k in
            ("samples", "samples_mask", "text_ids", "text_mask")]
    args.append(torch.from_numpy(batch["targets"]["size"]).cuda())
    vidx = torch.zeros(1, dtype=torch.int32, device="cuda")
    msda.launches = msda.bwd_launches = 0
    out = model(*args, valid_indices=vidx)
    torch.cuda.synchronize()
    launches, bwd = msda.launches, msda.bwd_launches
    check(launches == cfg.enc_layers + cfg.dec_layers,
          f"A2D forward launched MSDA {launches} times "
          f"(want {cfg.enc_layers + cfg.dec_layers})")
    check(bwd == 0, f"A2D forward launched the MSDA backward {bwd} times (want 0)")
    results["launches"]["a2d"] = launches
    results["bwd_launches"]["a2d"] = bwd
    log(f"a2d: one forward, {launches} MSDA launches")
    pm = out["pred_masks"]
    check(tuple(pm.shape) == (1, 1, 5, 384, 640), f"A2D pred_masks {tuple(pm.shape)}")
    check(bool(torch.isfinite(pm).all()), "A2D pred_masks not finite")
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        model(*args, valid_indices=vidx)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    log(f"a2d: eval forward 1x5x384x640 bf16 {dt * 1e3:.2f} ms, {5 / dt:.2f} clip frames/s")


# ------------------------------------------------------------------- train --
def phase_train(results):
    cfg = ytvos_r101_boxsup()
    t0 = time.perf_counter()
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    optimizer = build_optimizer(model, cfg)
    step = make_train_step(model, criterion_config(cfg), build_weight_dict(cfg), optimizer)
    batch = synthetic_batch(np.random.default_rng(0), batch=1, frames=3, height=512,
                            width=640)
    log(f"train: built {cfg.backbone} + RoBERTa {cfg.text_layers}x{cfg.text_hidden}, "
        f"{cfg.enc_layers}+{cfg.dec_layers} layers, {cfg.compute_dtype} compute, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, "
        f"{sum(len(g['params']) for g in optimizer.adamw.param_groups)} trained tensors "
        f"in {time.perf_counter() - t0:.1f} s")
    step(batch)                              # warm-up: cuDNN plans, Adam state
    torch.cuda.synchronize()

    labels = {name: param_group_label(cfg, name) for name, _ in model.named_parameters()}
    before = {name: p.detach().clone() for name, p in model.named_parameters()}
    msda.launches = msda.bwd_launches = 0
    metrics = step(batch)
    torch.cuda.synchronize()
    k1, k2 = msda.launches, msda.bwd_launches
    layers = cfg.enc_layers + cfg.dec_layers
    check(k1 == layers and k2 == layers,
          f"train step launched K1 {k1} and K2 {k2} times (want {layers} each)")
    results["launches"]["train"] = k1
    results["bwd_launches"]["train"] = k2
    bad = [k for k, v in metrics.items() if not math.isfinite(v)]
    check(not bad and metrics["finite"] == 1.0, f"train step: non-finite {bad}")
    moved = {}
    for name, p in model.named_parameters():
        same = torch.equal(p.detach(), before[name])
        if labels[name] == "frozen":
            check(same, f"frozen parameter {name} changed")
        else:
            n_moved, n_all = moved.get(labels[name], (0, 0))
            moved[labels[name]] = (n_moved + (not same), n_all + 1)
    check(all(n > 0 for n, _ in moved.values()), f"trained groups did not move: {moved}")
    del before
    log(f"train: one step, K1 x{k1}, K2 x{k2}; loss {metrics['loss']:.4f}, grad_norm "
        f"{metrics['grad_norm']:.4f}, all {len(metrics)} metrics finite; tensors moved "
        "by group: " + ", ".join(f"{g} {n}/{a}" for g, (n, a) in sorted(moved.items()))
        + "; frozen ones bit-identical")

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = sum(times) / len(times)
    log(f"train: B=1 T=3 512x640 step {ms:.2f} ms mean over {len(times)} (min "
        f"{min(times):.2f}, max {max(times):.2f}; " + ", ".join(f"{t:.2f}" for t in times)
        + f"), peak memory {peak:.2f} GiB")
    classes = profile_run("one train step (B=1, T=3, 512x640)", lambda: step(batch))
    if classes:
        total = sum(classes.values())
        log(f"train: K2 (msda_cm_bwd) {classes.get('msda_cm_bwd', 0.0):.2f} ms = "
            f"{100 * classes.get('msda_cm_bwd', 0.0) / total:.1f}% of device time; "
            f"K1 {classes.get('msda', 0.0):.2f} ms")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU", file=sys.stderr)
        return 2
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}")
    results = {"launches": {}, "bwd_launches": {}}

    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"build: {len(_build.SOURCES)} kernel source(s) in {secs:.1f} s "
        f"(phase {time.perf_counter() - t0:.1f} s)")
    for src, text in _build.build_logs.items():
        log(f"build log {src}:\n{text.strip()}")
    for name, fn in (("kernel", phase_kernel), ("card", lambda _: phase_card()),
                     ("serve", phase_serve), ("a2d", phase_a2d), ("train", phase_train)):
        t0 = time.perf_counter()
        fn(results)
        log(f"phase {name} ok in {time.perf_counter() - t0:.1f} s")

    # K1 timed at the serving encoder call (and at the train encoder), K2 at
    # the train encoder; launches counted on each path's run, the entry's own
    # on the train path
    def entry(name, source, replaces, k, by_path, **extra):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": by_path["train"], "launches_by_path": by_path,
                "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
                "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": None,
                **extra}

    kernels = [
        entry("ms_deform_attn_cm", "ocpg_tpu_torch/ops/csrc/ms_deform_attn_fwd.cu",
              "ocpg_tpu/ops/ms_deform_attn_pallas.py:620", results["msda"],
              results["launches"], at="serve encoder",
              train_encoder={k: results["msda_train"][k] for k in
                             ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}),
        entry("ms_deform_attn_cm_backward", "ocpg_tpu_torch/ops/csrc/ms_deform_attn_bwd.cu",
              "ocpg_tpu/ops/ms_deform_attn_pallas.py:994", results["msda_bwd"],
              results["bwd_launches"], at="train encoder"),
    ]
    print(nvidia_smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
