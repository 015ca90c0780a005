#!/usr/bin/env python3
"""Drive the PyTorch port (``ocpg_tpu_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

It takes no arguments and runs every phase; each fails the run (non-zero
exit, no result line) if it goes wrong:

1. build   -- compile every CUDA kernel of the port from ocpg_tpu_torch/ops/csrc.
2. kernel  -- each kernel against its plain PyTorch version on the card, at
              the shapes the serving and A2D paths give it, in float32 and
              bfloat16, with samples outside the map, on integer pixel
              coordinates and at NaN/inf coordinates; its time, the plain
              version's and the bound.
3. card    -- the small model's eval forward on the card (through the
              kernels) against the same weights on the CPU (through the plain
              versions), TF32 off, at the bounds of tests/test_golden_parity.py.
4. serve   -- the full-width YTVOS R101 model (ResNet-101, RoBERTa-base,
              4+4 layers, bf16) behind ClipInferenceEngine, answering uint8
              requests of mixed sizes; every answer has its request's shape
              and is finite, and MSDA launched 8 times per dispatch.
5. a2d     -- the A2D R101 eval forward on one 5 x 384 x 640 clip (bf16,
              valid_indices): finite masks of shape (1, 1, 5, 384, 640), and
              MSDA launched 8 times in the forward.

The launch counts of the serve and a2d phases are each reset just before
that phase's path runs and read just after.

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
from ocpg_tpu_torch.models.build import build_model
from ocpg_tpu_torch.models.text_encoder import SimpleTokenizer
from ocpg_tpu_torch.ops import _build
from ocpg_tpu_torch.ops import ms_deform_attn as msda

# H100 SXM (NVIDIA's data sheet): HBM rate and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# serving path: bucket 384 x 640, clip_len 5, one slot -> levels at strides 8..64
SERVE_SHAPES = ((48, 80), (24, 40), (12, 20), (6, 10))
SERVE_N, HEADS, HEAD_DIM, POINTS, QUERIES = 5, 8, 32, 4, 5


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


def msda_work(shapes, value, x, y, aw):
    """(bytes, flops) the function needs on these inputs: each input read
    once, the output written once; per in-map corner one weight product and
    a multiply-add per channel."""
    n, s, m, d = value.shape
    lq = x.shape[-1]
    nbytes = (value.numel() * value.element_size() + 3 * x.numel() * 4
              + n * lq * m * d * value.element_size())
    corners = 0
    for lid, (h, w) in enumerate(shapes):
        xp = x[:, :, lid] * w - 0.5
        yp = y[:, :, lid] * h - 0.5
        x0, y0 = torch.floor(xp), torch.floor(yp)
        for cx, cy in ((x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1, y0 + 1)):
            corners += int(((cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1)).sum())
    samples = x.numel()
    flops = corners * (2 * d + 2) + samples * 12
    return nbytes, flops


def phase_kernel(results):
    """K1 at the calls the main paths make: the serving encoder and decoder
    (N = clip_len frames) and the A2D ones (valid_indices leaves N = 1)."""
    lq_enc = sum(h * w for h, w in SERVE_SHAPES)
    calls = (("serve encoder", SERVE_N, lq_enc), ("serve decoder", SERVE_N, QUERIES),
             ("a2d encoder", 1, lq_enc), ("a2d decoder", 1, QUERIES))
    report = {}
    for name, n, lq in calls:
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            value, x, y, aw = msda_inputs(SERVE_SHAPES, n, lq, dtype, seed=7)
            got = msda.ms_deform_attn_cm(value, SERVE_SHAPES, x, y, aw)
            torch.cuda.synchronize()
            want = msda.ms_deform_attn_cm_reference(value.float(), SERVE_SHAPES, x, y, aw)
            check(bool(torch.isfinite(want).all()), f"MSDA {name}: plain version not finite")
            err = (got.float() - want).abs().max().item()
            scale = want.abs().max().item()
            check(math.isfinite(err) and err <= tol * scale,
                  f"MSDA {name} {dtype}: max |kernel - plain| {err} > "
                  f"{tol} x max |out| {scale}")
            log(f"kernel msda {name} N={n} Lq={lq} {str(dtype)[6:]}: max_abs_err "
                f"{err:.3e} (limit {tol} x {scale:.3f})")
            if dtype == torch.bfloat16:
                ms = cuda_ms(lambda: msda.ms_deform_attn_cm(value, SERVE_SHAPES, x, y, aw), 50)
                plain_ms = cuda_ms(lambda: msda.ms_deform_attn_cm_reference(
                    value, SERVE_SHAPES, x, y, aw), 10)
                nbytes, flops = msda_work(SERVE_SHAPES, value, x, y, aw)
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ops_ms = flops / F32_FLOPS_PER_S * 1e3
                gather_bytes = x.numel() * 4 * HEAD_DIM * value.element_size()
                log(f"kernel msda {name} bf16: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"bound {max(bytes_ms, ops_ms):.4f} ms ({nbytes / 1e6:.1f} MB at "
                    f"3.35 TB/s = {bytes_ms:.4f} ms; {flops / 1e9:.3f} GFLOP f32 = "
                    f"{ops_ms:.4f} ms); corner gathers {gather_bytes / 1e9:.3f} GB "
                    f"= {gather_bytes / (ms * 1e-3) / 1e12:.2f} TB/s through L2/L1")
                report[name] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                    max_abs_err=err)
    results["msda"] = report["serve encoder"]


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
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = False


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
    msda.launches = 0
    batches0 = engine.n_batches
    t0 = time.perf_counter()
    out = engine.run(requests, progress=lambda k: done.append(time.perf_counter() - t0))
    wall = time.perf_counter() - t0
    launches = msda.launches
    dispatches = engine.n_batches - batches0
    for r, o in zip(requests, out):
        check(o.shape == r.frames.shape[:3], f"answer {o.shape} for a {r.frames.shape} request")
        check(bool(np.isfinite(o).all()), "non-finite mask logits")
    check(launches == 8 * dispatches,
          f"MSDA launched {launches} times in {dispatches} dispatches (want 8 each)")
    frames = sum(r.frames.shape[0] for r in requests)
    log(f"serve: {len(requests)} requests, {frames} frames, {dispatches} dispatches, "
        f"{launches} MSDA launches, wall {wall:.3f} s, {frames / wall:.2f} frames/s")
    log("serve: per-request completion latency (s): "
        + ", ".join(f"{x:.3f}" for x in done))
    results["launches"]["serve"] = launches
    profile_dispatch(engine, requests[0])


KERNEL_CLASSES = (   # (class, substrings of CUDA kernel names), first match wins
    ("msda", ("msda_cm_fwd",)),
    ("fft", ("fft",)),
    ("conv", ("conv", "fprop", "dgrad", "implicit", "winograd", "cudnn")),
    ("gemm", ("gemm", "cutlass", "matmul", "sm90_xmma")),
    ("norm", ("norm",)),
    ("softmax", ("softmax",)),
    ("resize", ("upsample", "interp", "grid_sampler")),
    ("copy/cast", ("copy", "cat", "transpose", "permute", "fill")),
    ("elementwise/reduce", ("elementwise", "reduce", "vectorized", "unrolled")),
)


def profile_dispatch(engine, request):
    """One serving dispatch under torch.profiler: device busy share and
    device time by kernel class and by kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run([request])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0 and str(getattr(ev, "device_type", "")).endswith("CUDA"):
            by_kernel[ev.key] = (dev_us / 1e3, ev.count)
    busy_ms = sum(ms for ms, _ in by_kernel.values())
    if not by_kernel:
        log("profile: torch.profiler recorded no device time (not measured)")
        return
    classes = {}
    for name, (ms, _) in by_kernel.items():
        low = name.lower()
        cls = next((c for c, keys in KERNEL_CLASSES if any(k in low for k in keys)), "other")
        classes[cls] = classes.get(cls, 0.0) + ms
    launches = sum(n for _, n in by_kernel.values())
    log(f"profile: one dispatch ({request.frames.shape[0]} frames, canvas 384x640): "
        f"wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), {launches} kernel launches")
    log("profile: device ms by class: " + ", ".join(
        f"{c} {ms:.2f}" for c, ms in sorted(classes.items(), key=lambda kv: -kv[1])))
    for name, (ms, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"profile:   {ms:8.3f} ms  x{n:<5d} {name[:110]}")


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
    msda.launches = 0
    out = model(*args, valid_indices=vidx)
    torch.cuda.synchronize()
    launches = msda.launches
    check(launches == cfg.enc_layers + cfg.dec_layers,
          f"A2D forward launched MSDA {launches} times "
          f"(want {cfg.enc_layers + cfg.dec_layers})")
    results["launches"]["a2d"] = launches
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU", file=sys.stderr)
        return 2
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}")
    results = {"launches": {}}

    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"build: {len(_build.SOURCES)} kernel source(s) in {secs:.1f} s "
        f"(phase {time.perf_counter() - t0:.1f} s)")
    for src, text in _build.build_logs.items():
        log(f"build log {src}:\n{text.strip()}")
    for name, fn in (("kernel", phase_kernel), ("card", lambda _: phase_card()),
                     ("serve", phase_serve), ("a2d", phase_a2d)):
        t0 = time.perf_counter()
        fn(results)
        log(f"phase {name} ok in {time.perf_counter() - t0:.1f} s")

    # K1 timed at the serving encoder call; launches counted on each path's run
    k = results["msda"]
    kernels = [{
        "name": "ms_deform_attn_cm", "route": "cuda",
        "source": "ocpg_tpu_torch/ops/csrc/ms_deform_attn_fwd.cu",
        "replaces": "ocpg_tpu/ops/ms_deform_attn_pallas.py:620",
        "launches": results["launches"]["serve"],
        "launches_by_path": results["launches"],
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None,
    }]
    print(nvidia_smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
