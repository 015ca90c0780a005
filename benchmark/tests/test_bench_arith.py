"""The metric arithmetic: rates over the whole window, the p95 over all
requests, the idle share from a union of intervals, the rooflines from the
frozen counts, and the comparisons that decide ``correct``."""

import json
import math

import pytest
import torch

from benchmark import calibrate, check, counts, manifest, trace


def read(name, ctx):
    return manifest.metric_reader(name)(ctx)


def test_rates_are_over_the_whole_window():
    assert read("train_clips_per_s", {"kind": "train", "clips": 96, "window_s": 12.0}) == 8.0
    assert read("infer_frames_per_s", {"kind": "infer", "frames": 300, "window_s": 2.5}) == 120.0
    assert read("train_clips_per_s", {"kind": "infer", "frames": 1, "window_s": 1}) is None


def test_p95_is_over_every_request():
    lat = list(range(1, 101))          # 100 requests: the 95th by nearest rank
    assert read("infer_request_p95_ms", {"kind": "infer", "latencies_ms": lat[::-1]}) == 95
    assert read("infer_request_p95_ms", {"kind": "infer", "latencies_ms": [7.0]}) == 7.0
    assert read("infer_request_p95_ms", {"kind": "infer", "latencies_ms": []}) is None


def test_union_and_gaps():
    iv = [(0, 10), (5, 15), (20, 30), (29, 31)]
    assert trace.union_length(iv) == 26
    assert trace.gaps(iv, 0, 40) == [(15, 20), (31, 40)]
    assert trace.union_length([]) == 0


def _trace(tmp_path):
    ev = [
        {"ph": "X", "name": "bench.traced", "cat": "user_annotation", "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "name": "bench.step", "cat": "user_annotation", "ts": 0, "dur": 50, "tid": 1},
        {"ph": "X", "name": "bench.step", "cat": "user_annotation", "ts": 50, "dur": 50, "tid": 1},
        {"ph": "X", "name": "cudaStreamSynchronize", "cat": "cuda_runtime", "ts": 40, "dur": 8, "tid": 1},
        {"ph": "X", "name": "WindowAttentionFunctionBackward", "cat": "cpu_op", "ts": 60, "dur": 10, "tid": 2},
        {"ph": "X", "name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 61, "dur": 1, "tid": 2,
         "args": {"correlation": 7}},
        {"ph": "X", "name": "void msda_fwd_kernel<bf16>", "cat": "kernel", "ts": 10, "dur": 20, "tid": 9},
        {"ph": "X", "name": "ampere_gemm", "cat": "kernel", "ts": 20, "dur": 20, "tid": 9,
         "args": {"correlation": 7}},
        {"ph": "X", "name": "Memcpy HtoD (Pinned -> Device)", "cat": "gpu_memcpy", "ts": 70, "dur": 5, "tid": 9},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return trace.read_chrome_trace(str(path))


def test_trace_reduction(tmp_path):
    tr = _trace(tmp_path)
    assert tr.wall_us == 100 and tr.busy_us() == 35           # union, not the sum 45
    assert tr.kernel_us("msda_fwd_kernel") == 20
    assert tr.device_us_under("WindowAttentionFunctionBackward") == 20
    steps = tr.spans_named("bench.step")
    assert len(steps) == 2 and tr.sync_us_within(steps) == 8
    ctx = {"kind": "train", "trace": tr}
    assert read("idle_share.train", ctx) == pytest.approx(65.0)
    assert read("step_host_ms.train", ctx) == pytest.approx((100 - 8) / 2 / 1e3)
    assert read("step_device_ms.train", ctx) == pytest.approx(40 / 2 / 1e3)
    assert read("h2d_ms.train", ctx) == pytest.approx(5 / 2 / 1e3)
    gaps = tr.idle_gaps()
    assert gaps[0][1] == pytest.approx(30e-6) and gaps[0][0].startswith("bench.step")


def test_roofline_from_the_frozen_counts(tmp_path):
    tr = _trace(tmp_path)
    call = (((64, 80), (32, 40)), 3, 8, 32, 4, 6400, 2, False)
    fl, nb = counts.msda_fwd(*call[:6], 2)
    want = 100 * counts.bound_s(fl, nb) / 20e-6
    got = read("msda_roofline.train", {"kind": "train", "trace": tr, "msda_calls": [call]})
    assert got == pytest.approx(want)
    assert read("msda_roofline.train", {"kind": "train", "trace": tr, "msda_calls": []}) is None
    assert read("wattn_roofline.train", {"kind": "train", "trace": tr, "wattn_calls": []}) is None


def test_counts_match_the_shapes():
    # one sample of 1 level, 1 head, 1 point, D = 32: 4 corners x (2D + 2) + 12
    assert counts.msda_fwd([(4, 4)], 1, 1, 32, 1, 1, 2)[0] == 4 * 66 + 12
    assert counts.msda_bwd([(4, 4)], 1, 1, 32, 1, 1, 2)[0] == 4 * 4 * 32 + 40
    assert counts.wattn_fwd(2, 49, 4, 32, 2, None)[0] == 4 * 2 * 4 * 49 * 49 * 32
    assert counts.bound_s(counts.PEAK_FLOPS, 0) == 1.0


def test_mfu_reads_the_counted_work():
    ctx = {"kind": "train", "flops_per_step": counts.PEAK_FLOPS / 10, "steps": 20,
           "window_s": 10.0}
    assert read("mfu.train", ctx) == pytest.approx(20.0)
    ctx = {"kind": "infer", "flops_per_frame": counts.PEAK_FLOPS / 100, "frames": 500,
           "window_s": 10.0}
    assert read("mfu.infer", ctx) == pytest.approx(50.0)


def test_leaf_gaps_and_verdict():
    ref = {"a": 1.0, "b": 2.0, "c": 1e-9}
    assert calibrate.worst_leaf_gap({"a": 1.1, "b": 2.0, "c": 0.0}, ref) == (pytest.approx(0.1),
                                                                             "a")
    # a near-zero leaf is measured against the median leaf
    assert calibrate.worst_leaf_gap({"a": 1.0, "b": 2.0, "c": 1e-3}, ref)[0] == pytest.approx(1e-3)
    assert calibrate.worst_leaf_gap({"a": 1.0}, ref)[0] == 1.0        # missing leaves
    assert check.median_leaf_gap({"a": 1.1, "b": 2.0, "c": 0.0}, ref) == pytest.approx(1e-9)
    assert check.moved_leaves(ref) == ["a", "b"]
    assert calibrate.loss_gap([1.0, float("nan")], [1.0, 1.0]) == math.inf
    prog, other = torch.tensor([[0, 1, 2], [3, 4, 0]]), torch.tensor([[0, 1, 2], [3, 0, 0]])
    assert check.agreeing_layers(prog, other) == [0]
    assert check.disagreeing_slots(prog, other) == 1
    assert check.disagreeing_slots(prog, other[:, :1]) == 0           # clips both hold
    ok, checks = check.verdict({"x": 0.5, "y": math.inf}, {"x": 1.0, "y": 2.0})
    assert not ok and checks["y"]["value"] == "inf"
    assert check.verdict({"x": 0.5}, {"x": 1.0})[0]


def test_request_gaps_pick_the_nearest_query():
    ref = torch.stack([torch.ones(2, 3, 4), -torch.ones(2, 3, 4)])
    scores = torch.tensor([0.5, 0.2])
    mg, sg, q = check.request_gaps(-torch.ones(2, 3, 4) * 1.01, ref, scores)
    assert q == 1 and mg == pytest.approx(0.01, rel=1e-4) and sg == pytest.approx(0.3)
    assert check.request_gaps(torch.ones(1, 3, 4), ref, scores)[0] == math.inf
