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
                 NaN/inf coordinates; its backward (K2) at the train calls
                 against autograd through the plain version; the Swin window
                 attention (K7) at the four Video Swin-B serving calls with
                 and without the SW-MSA mask, and at a 2D Swin (n = 49) call,
                 its autograd Function's gradients against autograd through
                 the plain version.  Each kernel's time, the plain version's,
                 the bound and, for K7, scaled_dot_product_attention's.
3. card       -- the small models on the card (through the kernels) against
                 the same weights on the CPU (through the plain versions),
                 TF32 off: the ResNet eval forward (both branches) and the
                 Video Swin eval forward (DAVIS branch) at the bounds of
                 tests/test_golden_parity.py, and one train step with dropout
                 off (matched queries identical, every loss and grad_norm
                 within 1e-3 relative, K1 and K2 each launched once per
                 transformer layer).
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

Every launch counter (K1, K2, K7) is reset just before each of the phases
serve, a2d, train, swin_serve and swin_a2d runs its path and read just
after; the ``kernels`` line gives each kernel's count on every path.

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

from ocpg_tpu_torch.config import (OCPGConfig, a2d_r101_boxsup, davis_videoswin_base,
                                   ytvos_r101_boxsup)
from ocpg_tpu_torch.data.synthetic import synthetic_batch
from ocpg_tpu_torch.engine.infer import ClipInferenceEngine, InferRequest
from ocpg_tpu_torch.engine.optim import build_optimizer, param_group_label
from ocpg_tpu_torch.engine.train import make_train_step
from ocpg_tpu_torch.models import backbone_video_swin as video_swin
from ocpg_tpu_torch.models.build import build_model, build_weight_dict, criterion_config
from ocpg_tpu_torch.models.text_encoder import SimpleTokenizer
from ocpg_tpu_torch.ops import _build
from ocpg_tpu_torch.ops import ms_deform_attn as msda
from ocpg_tpu_torch.ops import window_attention as wattn

# H100 SXM (NVIDIA's data sheet): HBM rate, float32 rate outside the tensor
# cores, dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
# serving path: bucket 384 x 640, clip_len 5, one slot -> levels at strides 8..64
SERVE_SHAPES = ((48, 80), (24, 40), (12, 20), (6, 10))
SERVE_N, HEADS, HEAD_DIM, POINTS, QUERIES = 5, 8, 32, 4, 5
# train path: B=1 clip of T=3 frames at 512 x 640 -> levels at strides 8..64
TRAIN_SHAPES = ((64, 80), (32, 40), (16, 20), (8, 10))
TRAIN_N = 3
# Swin-B serving path (video_swin_b_p4w7, one 5 x 384 x 640 clip): the token
# grid and heads of each stage; the (8, 7, 7) window clamps to T = 5, n = 245
SWIN_T, SWIN_WINDOW, SWIN_HEAD_DIM = 5, (8, 7, 7), 32
SWIN_GRIDS = ((96, 160), (48, 80), (24, 40), (12, 20))
SWIN_HEADS = (4, 8, 16, 32)
SWIN_B_BLOCKS = 24
# launch counters of the port's kernels: (name, module, attribute)
COUNTERS = (("K1", msda, "launches"), ("K2", msda, "bwd_launches"),
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


def reset_counts() -> None:
    for _, mod, attr in COUNTERS:
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(mod, attr) for name, mod, attr in COUNTERS}


def timed_bound(nbytes, flops, flops_per_s=F32_FLOPS_PER_S):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / flops_per_s * 1e3
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
    wattn_kernel_checks(results)


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
    Swin module hands them over) and a bias table gather's stand-in."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dh = SWIN_HEAD_DIM
    qkv = torch.randn(bw, n, 3, heads, dh, generator=g, device="cuda").to(dtype)
    bias = torch.randn(heads, n, n, generator=g, device="cuda") * 0.5
    return qkv[:, :, 0] * dh ** -0.5, qkv[:, :, 1], qkv[:, :, 2], bias


def wattn_work(q, mask):
    """(bytes, flops) of one call: q, k, v, bias and the mask read once in
    the input's type, the output written once; the two products
    q.k^T and P.v (2 flops per multiply-add)."""
    bw, n, h, dh = q.shape
    es = q.element_size()
    nbytes = 4 * q.numel() * es + h * n * n * es
    if mask is not None:
        nbytes += mask.numel() * es
    return nbytes, 4 * bw * h * n * n * dh


def wattn_kernel_checks(results):
    """K7 at the four Video Swin-B serving calls (n = 245, dh = 32) and a
    2D Swin call (n = 49), each with the shifted block's SW-MSA mask and
    without, against the plain version on the same values in float32:
    within 1e-5 x max |out| for float32 inputs, and within the 2e-2
    (absolute + relative) bound of tests/test_window_attention_pallas.py for
    bfloat16 ones.  Then the autograd Function's gradients, and times."""
    import torch.nn.functional as F

    calls = [(f"swin-B stage {s}",) + swin_call(SWIN_GRIDS[s], SWIN_HEADS[s])
             for s in range(4)]
    calls.append(("swin2d-B stage 1 (1 frame)",)
                 + swin_call((48, 80), 8, window=(1, 7, 7), frames=1))
    report = {}
    for name, bw, heads, n, mask_np in calls:
        for masked in (True, False):
            mask = torch.from_numpy(mask_np).cuda() if masked else None
            label = f"{name} bw={bw} h={heads} n={n}{' masked' if masked else ''}"
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v, bias = wattn_inputs(bw, heads, n, dtype, seed=11)
                got = wattn.window_attention(q, k, v, bias, mask).float()
                torch.cuda.synchronize()
                want = wattn.window_attention_reference(q.float(), k.float(), v.float(),
                                                        bias.to(dtype).float(), mask)
                err = (got - want).abs().max().item()
                scale = want.abs().max().item()
                if dtype == torch.float32:
                    ok, limit = err <= 1e-5 * scale, f"1e-5 x {scale:.3f}"
                else:
                    excess = ((got - want).abs() - 2e-2 * want.abs()).max().item()
                    ok, limit = excess <= 2e-2, "2e-2 + 2e-2 x |out|"
                check(math.isfinite(err) and ok,
                      f"K7 {label} {dtype}: max |kernel - plain| {err} (limit {limit})")
                log(f"kernel wattn {label} {str(dtype)[6:]}: max_abs_err {err:.3e} "
                    f"(limit {limit})")
            # times in bf16, the serving type: the kernel, the plain version,
            # and scaled_dot_product_attention with bias + mask as its
            # attn_mask, built outside the timed calls
            qt, kt, vt = (t.permute(0, 2, 1, 3) for t in (q, k, v))
            attn_mask = bias.to(q.dtype)[None].expand(bw, -1, -1, -1)
            if mask is not None:
                attn_mask = (attn_mask + mask.to(q.dtype)[:, None]).contiguous()
            lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=attn_mask, scale=1.0)
            lib_err = ((lib.permute(0, 2, 1, 3).float() - want).abs()
                       - 2e-2 * want.abs()).max().item()
            check(lib_err <= 2e-2, f"K7 {label}: scaled_dot_product_attention disagrees "
                                   f"with the plain version ({lib_err})")
            ms = cuda_ms(lambda: wattn.window_attention(q, k, v, bias, mask), 20)
            plain_ms = cuda_ms(lambda: wattn.window_attention_reference(q, k, v, bias, mask), 5)
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=attn_mask, scale=1.0), 20)
            nbytes, flops = wattn_work(q, mask)
            bound_ms, bound_by = timed_bound(nbytes, flops, BF16_FLOPS_PER_S)
            log(f"kernel wattn {label} bf16: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
                f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP); "
                f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s")
            report[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                 bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)
            del q, k, v, bias, qt, kt, vt, attn_mask, lib, got, want

    # the Function's gradients (plain recompute, as the JAX custom VJP)
    # against autograd through the plain version, float32, with the mask
    for stage in (0, 3):
        _, bw, heads, n, mask_np = calls[stage]
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
                  f"K7 Function {gname} at stage {stage}: {e} > 1e-5 x {sc}")
            log(f"kernel wattn Function backward stage {stage} {gname}: max_abs_err "
                f"{e:.3e} (limit 1e-5 x {sc:.4g})")
    results["wattn"] = report[next(iter(report))]       # stage 0, masked
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
    want = {"K1": 8 * dispatches, "K2": 0, "K7": k7_per_dispatch * dispatches}
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
    classes = serve_path(results, "swin_serve", davis_videoswin_base(), SWIN_B_BLOCKS)
    if classes:
        k7 = classes.get("wattn", 0.0)
        log(f"swin_serve: K7 (wattn_fwd) {k7:.2f} ms = "
            f"{100 * k7 / sum(classes.values()):.1f}% of a dispatch's device time; "
            f"K1 {classes.get('msda', 0.0):.2f} ms")


KERNEL_CLASSES = (   # (class, substrings of CUDA kernel names), first match wins
    ("wattn", ("wattn_fwd",)),
    ("msda_cm_bwd", ("msda_cm_bwd",)),
    ("msda", ("msda_cm_fwd",)),
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
    want = {"K1": cfg.enc_layers + cfg.dec_layers, "K2": 0, "K7": k7}
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
    reset_counts()
    metrics = step(batch)
    torch.cuda.synchronize()
    counts = read_counts()
    k1, k2 = counts["K1"], counts["K2"]
    layers = cfg.enc_layers + cfg.dec_layers
    check(counts == {"K1": layers, "K2": layers, "K7": 0},
          f"train step launched {counts} (want K1 and K2 {layers} times each, K7 never)")
    results["paths"]["train"] = counts
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
    results = {"paths": {}}

    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"build: {len(_build.SOURCES)} kernel source(s) in {secs:.1f} s "
        f"(phase {time.perf_counter() - t0:.1f} s)")
    for src, text in _build.build_logs.items():
        log(f"build log {src}:\n{text.strip()}")
    for name, fn in (("kernel", phase_kernel), ("card", lambda _: phase_card()),
                     ("serve", phase_serve), ("a2d", phase_a2d), ("train", phase_train),
                     ("swin_serve", phase_swin_serve), ("swin_a2d", phase_swin_a2d)):
        t0 = time.perf_counter()
        fn(results)
        log(f"phase {name} ok in {time.perf_counter() - t0:.1f} s")

    # K1 timed at the serving encoder call (and at the train encoder), K2 at
    # the train encoder, K7 at the Swin-B stage-0 call of a shifted block;
    # launches counted on each path's run, the entry's own on its main path
    # (train for K1 and K2, swin_serve for K7)
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
                             ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}),
        entry("ms_deform_attn_cm_backward", "ocpg_tpu_torch/ops/csrc/ms_deform_attn_bwd.cu",
              "ocpg_tpu/ops/ms_deform_attn_pallas.py:994", results["msda_bwd"], "K2", "train",
              at="train encoder"),
        entry("window_attention", "ocpg_tpu_torch/ops/csrc/window_attention_fwd.cu",
              "ocpg_tpu/ops/window_attention_pallas.py:139", results["wattn"], "K7",
              "swin_serve", at="swin-B stage 0, shifted block (bw=322, h=4, n=245, dh=32)",
              by_call=results["wattn_report"]),
    ]
    print(nvidia_smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
