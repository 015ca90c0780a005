"""Runs a ``"work": "videos"`` mix: one client in a closed loop, one
``engine/infer.py::ClipInferenceEngine.run`` call per video carrying one
request per expression, as ``cli/infer_ytvos.py`` sends them.

Set-up builds the model (``models/build.py``, eval mode), loads the run's
weights (``weights.py``), builds the engine with the mix's ``engine``
settings, makes the pool of videos (``generate.make_videos``) and warms
every canvas the pool uses with one video of each.  The window then runs
the pool's videos in the seed's order, one after another, until
``--seconds`` have passed; each request's latency runs from the start of
its video's ``run()`` to its masks on the host (the engine's ``progress``
callback).  The masks of the window's first ``sample`` videos (the seed's
order puts the longest first) are kept as served.  With ``--trace 1`` two
more videos run under the profiler.  Then the program is freed and the
reference (``reference/step.py``) runs each sampled request in float32
with TF32 off.
"""

from __future__ import annotations

import time
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from benchmark import check, counts, device as dev, generate, trace, weights
from benchmark.reference import lowp, plain_ops
from benchmark.reference.step import reference_request

TRACED_VIDEOS = 2


def model_fields(cell) -> Dict:
    return dict(cell.config["model"])


def build_engine(fields: Mapping, mix: Mapping, seed: int, device):
    from ocpg_tpu_torch.config import OCPGConfig
    from ocpg_tpu_torch.engine.infer import ClipInferenceEngine
    from ocpg_tpu_torch.models.build import build_model

    model = build_model(OCPGConfig(**fields), device)
    weights.load_weights(model, weights.draw_for(fields, seed, device))
    e = mix["engine"]
    return ClipInferenceEngine(model, clip_len=e["clip_len"],
                               buckets=tuple(tuple(b) for b in e["buckets"]),
                               slots=e["slots"], pipeline_depth=e["pipeline_depth"],
                               out_dtype=getattr(torch, e["out_dtype"]), device=device)


def requests_of(video: generate.Video) -> List:
    from ocpg_tpu_torch.engine.infer import InferRequest

    return [InferRequest(video.frames, ids, mask) for ids, mask in video.texts]


def canvas_of(video: generate.Video, mix: Mapping):
    from ocpg_tpu_torch.engine.infer import pick_bucket

    h, w = video.frames.shape[1:3]
    return pick_bucket(h, w, tuple(tuple(b) for b in mix["engine"]["buckets"]))


def serving_order(pool: List[generate.Video], seed: int) -> List[int]:
    """The pool's videos in the seed's order, the longest first: the window
    keeps the masks of its first ``sample`` videos for the check, so the
    sample is drawn from the seed and holds the longest video."""
    order = np.random.default_rng(seed + 11).permutation(len(pool)).tolist()
    longest = max(order, key=lambda i: pool[i].frames.shape[0])
    order.remove(longest)
    return [longest] + order


def serve(engine, video, on_done) -> None:
    """One video's ``run()``; ``on_done(k, seconds)`` per request as its masks land."""
    done = [0]
    start = time.perf_counter()

    def progress(n):
        now = time.perf_counter() - start
        for _ in range(n):
            on_done(done[0], now)
            done[0] += 1

    return engine.run(requests_of(video), progress=progress)


def reference_gaps(fields, seed: int, pool, served: Dict[int, List[np.ndarray]], mix,
                   device, put: Optional[str] = None) -> Dict[str, float]:
    """The worst mask and score gaps of the served requests against the
    reference.  ``put`` hands back, in the program's place, the control's
    masks (``"control"``: the reference one precision down, the
    configuration's bfloat16 with float8 operands, its best query) or the
    reference's worst-scored query's (``"wrong_query"``: a fault)."""
    dev.float32_proper(device)
    ref = weights.reference_model(fields, seed, device)
    ref.eval().requires_grad_(False)
    low = None
    if put == "control":
        low = weights.reference_model(fields, seed, device, fields["compute_dtype"])
        low.eval().requires_grad_(False)
    clip_len = mix["engine"]["clip_len"]
    mask_gap = score_gap = 0.0
    for vi, masks in served.items():
        video = pool[vi]
        for (ids, tmask), m in zip(video.texts, masks):
            ref_masks, ref_scores = reference_request(ref, video.frames, ids, tmask,
                                                      canvas_of(video, mix), clip_len)
            if put == "control":
                with lowp.Float8Operands():
                    low_masks, low_scores = reference_request(
                        low, video.frames, ids, tmask, canvas_of(video, mix), clip_len)
                m = low_masks[int(low_scores.argmax())]
            elif put == "wrong_query":
                m = ref_masks[int(ref_scores.argmin())]
            mg, sg, _ = check.request_gaps(torch.as_tensor(m), ref_masks, ref_scores)
            mask_gap, score_gap = max(mask_gap, mg), max(score_gap, sg)
    del ref, low
    dev.free(device)
    return {"mask_gap": mask_gap, "score_gap": score_gap}


def count_forward_flops(fields, seed: int, video, mix, device) -> float:
    """FLOPs of one reference forward at the engine's padded clip (the best
    query refined): ``FlopCounterMode``'s products plus the frozen MSDA counts."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference.step import normalize_frames

    ref = weights.reference_model(fields, seed, device)
    ref.eval().requires_grad_(False)
    clip_len = mix["engine"]["clip_len"]
    bh, bw = canvas_of(video, mix)
    t, h, w = video.frames.shape[:3]
    samples = torch.zeros((1, clip_len, bh, bw, 3), dtype=torch.uint8, device=device)
    samples[0, :t, :h, :w] = torch.from_numpy(video.frames).to(device)
    smask = torch.ones((1, clip_len, bh, bw), dtype=torch.bool, device=device)
    smask[0, :t, :h, :w] = False
    ids, tmask = (torch.from_numpy(x)[None].to(device) for x in video.texts[0])
    sizes = torch.tensor([[h, w]], dtype=torch.int32, device=device)
    plain_ops.MSDA_CALLS = []
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            ref(normalize_frames(samples, smask), smask, ids, tmask, sizes)
        calls = plain_ops.MSDA_CALLS
    finally:
        plain_ops.MSDA_CALLS = None
    total = float(fc.get_total_flops())
    for shapes, n, m, d, p, lq, _ in calls:
        total += counts.msda_fwd(shapes, n, m, d, p, lq, 4)[0]
    del ref
    dev.free(device)
    return total


def run(cell, args, device: str = "cuda", t0: float = 0.0) -> Dict:
    mix, seed = cell.traffic, args.seed
    fields = model_fields(cell)
    engine = build_engine(fields, mix, seed, device)
    pool = generate.make_videos(mix, seed, device)
    order = serving_order(pool, seed)
    # warm every canvas of the pool once
    warmed = {}
    for vi, video in enumerate(pool):
        warmed.setdefault(canvas_of(video, mix), vi)
    for vi in warmed.values():
        engine.run(requests_of(pool[vi])[:1])
    dev.synchronize(device)
    setup_s = time.perf_counter() - t0
    peak = dev.peak_bytes(device)
    dev.reset_peak(device)

    latencies: List[float] = []
    frames = 0
    served: Dict[int, List[np.ndarray]] = {}
    k, start = 0, time.perf_counter()
    while True:
        vi = order[k % len(order)]
        video = pool[vi]
        k += 1
        results = serve(engine, video, lambda j, s: latencies.append(s * 1e3))
        frames += video.frames.shape[0] * len(results)
        if k <= mix["sample"]:
            served[vi] = results
        now = time.perf_counter()
        if now - start >= args.seconds:
            break
    window_s = now - start
    window_peak = dev.peak_bytes(device)
    ctx = {"kind": "infer", "setup_s": setup_s, "window_s": window_s,
           "latencies_ms": latencies, "frames": frames, "videos": k}
    out = {"attempted": len(latencies), "failed": 0,
           "memory_peak_bytes": max(peak, window_peak)}
    if args.trace:
        tracer = trace.Tracer()
        tracer.hook_module(engine.model, "bench.forward")
        traced_frames = traced_requests = 0

        def tail():
            nonlocal k, traced_frames, traced_requests
            with tracer.record_calls():
                for _ in range(TRACED_VIDEOS):
                    video = pool[order[k % len(order)]]
                    k += 1
                    with torch.profiler.record_function("bench.run"):
                        res = engine.run(requests_of(video))
                    traced_requests += len(res)
                    traced_frames += video.frames.shape[0] * len(res)

        tr = trace.profile(tail, device)
        ctx.update(trace=tr, traced_requests=traced_requests, traced_frames=traced_frames,
                   msda_calls=tracer.msda_calls, wattn_calls=tracer.wattn_calls,
                   clip_len=mix["engine"]["clip_len"])
        out["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}

    del engine
    dev.free(device)
    values = reference_gaps(fields, seed, pool, served, mix, device)
    out["correct"], out["checks"] = check.verdict(values, cell.limits)
    out["correct"] = out["correct"] and bool(served)
    if args.trace:
        ctx["flops_per_frame"] = count_forward_flops(
            fields, seed, pool[order[0]], mix, device) / mix["engine"]["clip_len"]
    out["ctx"] = ctx
    return out
