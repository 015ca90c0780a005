"""The port's FLOP accounting and its bench (``ocpg_tpu_torch/scripts/
bench.py``, ``bench_train.py``) on the CPU, at small sizes, against the JAX
package where it has a counterpart.

* ``count_msda_flops``: one forward entry per transformer layer (encoder +
  decoder) in an eval forward, the same again as backward entries in a
  train step, nothing outside the context; one ``wattn_fwd`` entry per
  Swin block with its ``4 bw h n^2 dh``.
* The shape-only MSDA counts equal ``msda_work``/``msda_bwd_work`` when
  every bilinear corner lies in its map and are never below them, and
  ``in_map_corners`` equals a brute-force count.
* The dense count (``bench.count_flops``) against the JAX forward's
  ``cost_analysis()["flops"]`` (lowered, not compiled) on the same small
  configuration, the JAX side with ``msda_impl="xla"`` (the gather version:
  its only MSDA matmul is the attention-weighted sum, where
  ``"separable"`` would add the dense hat matmuls and ``"pallas"`` the
  kernel's executed work) and the XLA window attention.  The port's dense
  count plus its kernel entries over JAX's count: 1.0747 for the ResNet-50
  A2D forward, 0.9775 for the ``video_swin_test`` one (measured); the
  bound is [0.9, 1.1].  The two counters differ by design: FlopCounterMode
  counts every tap of a padded convolution (XLA only those inside the
  input: 7.3% more for a 3 x 3 convolution at 16 x 24) and counts no
  elementwise, normalisation, softmax or FFT work, which XLA's count holds.
  The dispatchers hide their own forward from the dense count on the CPU,
  as the kernels are hidden on the card, so nothing is counted twice.
* ``bench.measure``/``measure_train`` with ``device="cpu"`` at a small
  configuration return every key; the stages' batch equals JAX's
  ``synthetic_batch(default_rng(0))``; a tiny ``OCPG_BENCH_BUDGET_S`` lists
  the skipped stages; SIGTERM mid-stage prints exactly one JSON line with
  ``running_stage`` set; a failing stage makes the exit code non-zero.
* ``bench_train.main``: the timing record (with ``--json_out``),
  ``--overfit`` and ``--e2e`` on a Ref-DAVIS tree, on the CPU.
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ocpg_tpu.config import OCPGConfig as JaxConfig
from ocpg_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from ocpg_tpu.models import build_model as jax_build_model

from ocpg_tpu_torch.config import OCPGConfig
from ocpg_tpu_torch.engine.optim import build_optimizer
from ocpg_tpu_torch.engine.train import TrainStep
from ocpg_tpu_torch.models.build import build_model, build_weight_dict, criterion_config
from ocpg_tpu_torch.ops import ms_deform_attn as msda
from ocpg_tpu_torch.ops import window_attention as wattn
from ocpg_tpu_torch.scripts import bench, bench_train

from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
B, T, H, W, LT = 1, 2, 64, 96, 8
SMALL = dict(backbone="resnet50", enc_layers=1, dec_layers=2, dim_feedforward=64,
             num_queries=5, num_frames=T, compute_dtype="float32", dataset_file="a2d",
             text_layers=2, text_hidden=128, text_heads=4, text_ffn=256, text_vocab=1000,
             text_max_pos=40)
DENSE_RATIO_BOUNDS = (0.9, 1.1)


def small(**kw):
    return OCPGConfig(**{**SMALL, **kw})


def inputs(seed=0, branch="a2d"):
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((B, T, H, W, 3)).astype(np.float32),
              np.zeros((B, T, H, W), bool), rng.integers(4, 1000, (B, LT)).astype(np.int32),
              np.ones((B, LT), np.int32), np.asarray([[H, W]], np.int32))
    return arrays, (np.zeros((B,), np.int32) if branch == "a2d" else None)


# ------------------------------------------------------------ MSDA entries --
def test_msda_entries_per_forward_and_step():
    cfg = small(dataset_file="ytvos")
    layers = cfg.enc_layers + cfg.dec_layers
    model = build_model(cfg, device="cpu")
    arrays, _ = inputs()
    args = [torch.from_numpy(a) for a in arrays]
    with msda.count_msda_flops() as entries:
        model(*args)
    assert [d for d, _ in entries] == ["fwd"] * layers
    assert all(f > 0 for _, f in entries)

    step = TrainStep(model, criterion_config(cfg), build_weight_dict(cfg),
                     build_optimizer(model, cfg))
    batch = bench.bench_batch(B, T, H, W, cfg.text_vocab)
    with msda.count_msda_flops() as step_entries:
        step(batch)
    fwd = [f for d, f in step_entries if d == "fwd"]
    bwd = [f for d, f in step_entries if d == "bwd"]
    assert len(fwd) == len(bwd) == layers and len(step_entries) == 2 * layers
    assert sorted(b / f for f, b in zip(sorted(fwd), sorted(bwd))) == pytest.approx(
        [(4 * 4 * 32 + 40) / (4 * (2 * 32 + 2) + 12)] * layers)
    # nothing is recorded outside a context, and a closed context stays as it was
    model(*args)
    step(batch)
    assert len(entries) == layers and len(step_entries) == 2 * layers


def test_msda_backward_outside_the_context_is_not_recorded():
    value, x, y, aw = _msda_inputs(np.random.default_rng(1), lo=0.2, hi=0.8)
    value.requires_grad_()
    with msda.count_msda_flops() as entries:
        out = msda.ms_deform_attn_cm(value, SHAPES, x, y, aw)
    out.sum().backward()
    assert [d for d, _ in entries] == ["fwd"]
    assert value.grad is not None


# ------------------------------------------------------------ MSDA formula --
SHAPES = ((4, 6), (2, 3))
N, M, D, P, LQ = 2, 2, 8, 3, 5


def _msda_inputs(rng, lo, hi):
    s = sum(h * w for h, w in SHAPES)
    value = torch.from_numpy(rng.standard_normal((N, s, M, D)).astype(np.float32))
    x, y, aw = (torch.from_numpy(rng.uniform(lo, hi, (N, M, len(SHAPES), P, LQ)).astype(
        np.float32)) for _ in range(3))
    return value, x, y, aw


def brute_force_corners(shapes, x, y):
    corners = 0
    for idx in np.ndindex(*x.shape):
        h, w = shapes[idx[2]]
        xp, yp = float(x[idx]) * w - 0.5, float(y[idx]) * h - 0.5
        x0, y0 = np.floor(xp), np.floor(yp)
        for cx in (x0, x0 + 1):
            for cy in (y0, y0 + 1):
                corners += 0 <= cx <= w - 1 and 0 <= cy <= h - 1
    return corners


@pytest.mark.parametrize("coords", ["in_map", "any"])
def test_msda_shape_count_against_the_work_on_data(coords):
    rng = np.random.default_rng(2)
    # in_map: every corner inside (x * W - 0.5 in [0, W - 1] on the coarsest level)
    lo, hi = (1.0 / 3, 2.0 / 3) if coords == "in_map" else (-0.3, 1.3)
    value, x, y, aw = _msda_inputs(rng, lo, hi)
    corners = msda.in_map_corners(SHAPES, x, y)
    assert corners == brute_force_corners(SHAPES, x.numpy(), y.numpy())
    fwd = msda.msda_fwd_flops(SHAPES, N, M, D, P, LQ)
    bwd = msda.msda_bwd_flops(SHAPES, N, M, D, P, LQ)
    work_fwd = msda.msda_work(SHAPES, value, x, y, aw)[1]
    work_bwd = msda.msda_bwd_work(SHAPES, value, x, y, aw)[1]
    if coords == "in_map":
        assert corners == 4 * x.numel()
        assert (fwd, bwd) == (work_fwd, work_bwd)
    else:
        assert 0 < corners < 4 * x.numel()
        assert fwd > work_fwd and bwd > work_bwd


def test_msda_std_layout_records_like_the_cm_layout():
    value, x, y, aw = _msda_inputs(np.random.default_rng(3), 0.1, 0.9)
    locs, attn = msda._cm_to_standard(x, y, aw)
    value.requires_grad_()
    with msda.count_msda_flops() as entries:
        msda.ms_deform_attn_fast(value, SHAPES, locs, attn).sum().backward()
    assert entries == [("fwd", msda.msda_fwd_flops(SHAPES, N, M, D, P, LQ)),
                       ("bwd", msda.msda_bwd_flops(SHAPES, N, M, D, P, LQ))]


# ------------------------------------------------------------- K7 entries --
def test_window_attention_entries_one_per_block(monkeypatch):
    cfg = small(backbone="video_swin_test")
    model = build_model(cfg, device="cpu")
    arrays, vi = inputs(4)
    shapes = []
    reference = wattn.window_attention_reference

    def spy(q, *rest):
        shapes.append(tuple(q.shape))
        return reference(q, *rest)

    monkeypatch.setattr(wattn, "window_attention_reference", spy)
    with msda.count_msda_flops() as entries:
        model(*[torch.from_numpy(a) for a in arrays], torch.from_numpy(vi))
    k7 = [f for d, f in entries if d == "wattn_fwd"]
    assert len(k7) == len(shapes) == 1 + 1 + 2 + 1     # video_swin_test's depths
    assert k7 == [4.0 * bw * h * n * n * dh for bw, n, h, dh in shapes]
    assert [d for d, _ in entries].count("fwd") == cfg.enc_layers + cfg.dec_layers


def test_dispatchers_hide_their_forward_from_the_dense_count():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(6, 10, 2, 8, generator=g) for _ in range(3))
    bias = torch.randn(2, 10, 10, generator=g)
    dense, kernels = bench.count_flops(lambda: wattn.window_attention(q, k, v, bias))
    assert dense == 0 and kernels == wattn.wattn_fwd_flops(6, 10, 2, 8) == 4 * 6 * 2 * 100 * 8
    # the plain version alone is two batched products the dense count sees
    plain, none = bench.count_flops(lambda: wattn.window_attention_reference(q, k, v, bias))
    assert plain == kernels and none == 0


# ------------------------------------------------------ dense vs JAX HLO --
def _jax_flops(jcfg, arrays, vi):
    jmodel, *_ = jax_build_model(jcfg)
    x, m, ids, tm, sz = map(jnp.asarray, arrays)
    jvi = None if vi is None else jnp.asarray(vi)
    params = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x, m, ids, tm, sz,
                                                valid_indices=jvi, train=False))
    lowered = jax.jit(lambda p: jmodel.apply(p, x, m, ids, tm, sz, valid_indices=jvi,
                                             train=False)["pred_masks"]).lower(params)
    cost = lowered.cost_analysis()
    return float((cost[0] if isinstance(cost, list) else cost)["flops"])


@pytest.mark.parametrize("backbone", ["resnet50", "video_swin_test"])
def test_dense_count_against_jax_cost_analysis(backbone):
    cfg = small(backbone=backbone)
    jcfg = JaxConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                        if f.name in {g.name for g in dataclasses.fields(JaxConfig)}})
    jcfg = jcfg.replace(msda_impl="xla", swin_attn_impl="xla")
    arrays, vi = inputs(5)
    want = _jax_flops(jcfg, arrays, vi)
    model = build_model(cfg, device="cpu")
    dense, kernels = bench.count_flops(
        lambda: model(*[torch.from_numpy(a) for a in arrays], torch.from_numpy(vi)))
    assert dense > 0 and kernels > 0
    lo, hi = DENSE_RATIO_BOUNDS
    assert lo <= (dense + kernels) / want <= hi, (dense, kernels, want)


# ------------------------------------------------------------------ bench --
def test_bench_batch_is_the_jax_benchs():
    got = bench.bench_batch(1, bench.FRAMES, bench.HEIGHT, bench.WIDTH)
    want = jax_synthetic_batch(np.random.default_rng(0), batch=1, frames=bench.FRAMES,
                               height=bench.HEIGHT, width=bench.WIDTH)

    def leaves(tree, path=""):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                yield from leaves(tree[k], f"{path}{k}/")
            else:
                yield f"{path}{k}", np.asarray(tree[k])

    got, want = dict(leaves(got)), dict(leaves(want))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_measure_and_measure_train_return_every_key():
    r = bench.measure("resnet50", 1, device="cpu", cfg=small(), frames=T, height=H, width=W,
                      iters=(2, 1, 1))
    assert set(r) == {"fps", "mfu_dense", "mfu_incl", "gflop_dense", "gflop_kernels", "calls"}
    assert r["calls"] == bench.WARMUP + 1 + 3
    assert r["fps"] > 0 and r["gflop_dense"] > 0 and r["gflop_kernels"] > 0
    assert 0 < r["mfu_dense"] < r["mfu_incl"] < 1
    r = bench.measure_train(bsz=1, frames=T, height=H, width=W, device="cpu",
                            cfg=small(dataset_file="ytvos"), iters=(2, 1, 1))
    assert set(r) == {"step_ms", "fps", "mfu_dense", "mfu_incl", "gflop_dense",
                      "gflop_kernels", "loss", "calls"}
    assert r["calls"] == bench.WARMUP + 1 + 3 + 1
    assert r["step_ms"] > 0 and np.isfinite(r["loss"]) and 0 < r["mfu_incl"] < 1


def _fake_measure(backbone, bsz, **kw):
    return {"fps": 10.0, "mfu_dense": 0.1, "mfu_incl": 0.2, "gflop_dense": 1.0,
            "gflop_kernels": 0.5, "calls": 3}


def _fake_train(backbone="resnet101", bsz=1, *a, **kw):
    return {"step_ms": 100.0, "fps": 30.0, "mfu_dense": 0.1, "mfu_incl": 0.2,
            "gflop_dense": 1.0, "gflop_kernels": 0.5, "loss": 1.0, "calls": 4}


def _clear_env(monkeypatch):
    for k in ("OCPG_BENCH_BACKBONE", "OCPG_BENCH_BATCH", "OCPG_BENCH_SKIP_SWIN",
              "OCPG_BENCH_SKIP_TRAIN", "OCPG_BENCH_BUDGET_S"):
        monkeypatch.delenv(k, raising=False)


def test_run_records_every_stage(monkeypatch, capsys):
    _clear_env(monkeypatch)
    monkeypatch.setattr(bench, "measure", _fake_measure)
    monkeypatch.setattr(bench, "measure_train", _fake_train)
    record, rc = bench.run(device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(lines) == 1 and json.loads(lines[0]) == record
    assert record["skipped"] == [] and record["running_stage"] is None
    assert list(record["stage_wall_s"]) == ["headline", "swin_b", "train_bs1", "train_bs2"]
    assert record["calls"] == {"headline": 3, "swin_b": 3, "train_bs1": 4, "train_bs2": 4}
    assert all(c == dict.fromkeys(c, 0) for c in record["launches"].values())
    want_keys = {
        "metric", "value", "unit", "budget_s", "skipped", "stage_wall_s", "running_stage",
        "launches", "calls", "gpu_kind", "assumed_peak_tflops_bf16", "peak_is_fallback_guess",
        "nvidia_smi", "wall_s", "model_mfu_dense", "model_mfu_incl_custom_calls",
        "model_gflop_per_clip_dense", "model_gflop_per_clip_kernels", "swin_b_fps",
        "swin_b_model_mfu_dense", "swin_b_model_mfu_incl_custom_calls",
        "swin_b_model_gflop_per_clip_dense", "swin_b_model_gflop_per_clip_kernels",
        "train_step_ms", "train_frames_per_sec_per_chip", "train_mfu_dense",
        "train_mfu_incl_custom_calls", "train_gflop_per_step_dense",
        "train_gflop_per_step_kernels", "train_b2_step_ms",
        "train_b2_frames_per_sec_per_chip", "train_b2_mfu_dense",
        "train_b2_mfu_incl_custom_calls", "train_b2_gflop_per_step_dense",
        "train_b2_gflop_per_step_kernels"}
    assert set(record) == want_keys
    assert record["metric"] == "clip_frames_per_sec_per_chip_a2d_r101"
    assert record["value"] == 10.0 and record["train_b2_step_ms"] == 100.0
    assert record["assumed_peak_tflops_bf16"] == 989.0 and record["peak_is_fallback_guess"]
    assert "vs_baseline" not in record


def test_tiny_budget_lists_the_skipped_stages(monkeypatch, capsys):
    _clear_env(monkeypatch)
    monkeypatch.setenv("OCPG_BENCH_BUDGET_S", "1")
    monkeypatch.setattr(bench, "measure", _fake_measure)
    monkeypatch.setattr(bench, "measure_train", _fake_train)
    record, rc = bench.run(device="cpu")
    assert rc == 0 and record["budget_s"] == 1.0
    assert record["skipped"] == ["swin_b", "train_bs1", "train_bs2"]
    assert list(record["stage_wall_s"]) == ["headline"] and record["value"] == 10.0
    assert len(capsys.readouterr().out.strip().splitlines()) == 1


def test_env_knobs_pick_the_stages(monkeypatch):
    _clear_env(monkeypatch)
    monkeypatch.setenv("OCPG_BENCH_BACKBONE", "video_swin_b_p4w7")
    monkeypatch.setenv("OCPG_BENCH_BATCH", "2")
    seen = []
    monkeypatch.setattr(bench, "measure",
                        lambda backbone, bsz, **kw: seen.append((backbone, bsz))
                        or _fake_measure(backbone, bsz))
    record, rc = bench.run(device="cpu")
    assert rc == 0 and seen == [("video_swin_b_p4w7", 2)]
    assert record["metric"] == "clip_frames_per_sec_per_chip_a2d_video_swin_b_p4w7_b2"
    assert list(record["stage_wall_s"]) == ["headline"] and record["skipped"] == []
    _clear_env(monkeypatch)
    monkeypatch.setenv("OCPG_BENCH_SKIP_SWIN", "1")
    monkeypatch.setenv("OCPG_BENCH_SKIP_TRAIN", "1")
    record, rc = bench.run(device="cpu")
    assert list(record["stage_wall_s"]) == ["headline"]


def test_a_failing_stage_exits_non_zero(monkeypatch, capsys):
    _clear_env(monkeypatch)

    def broken(*a, **kw):
        raise RuntimeError("the swin stage broke")

    monkeypatch.setattr(bench, "measure",
                        lambda backbone, bsz, **kw: broken() if "swin" in backbone
                        else _fake_measure(backbone, bsz))
    monkeypatch.setattr(bench, "measure_train", _fake_train)
    record, rc = bench.run(device="cpu")
    captured = capsys.readouterr()
    assert rc == 1 and record["skipped"] == ["swin_b:failed"]
    assert "the swin stage broke" in captured.err
    assert list(record["stage_wall_s"]) == ["headline", "swin_b", "train_bs1", "train_bs2"]
    assert "swin_b_fps" not in record and record["train_b2_step_ms"] == 100.0
    assert len(captured.out.strip().splitlines()) == 1


SIGTERM_CHILD = """
import sys, time
from ocpg_tpu_torch.scripts import bench

def slow(*args, **kwargs):
    print("STAGE", flush=True, file=sys.stderr)
    time.sleep(120)

bench.measure = slow
sys.exit(bench.run(device="cpu")[1])
"""


def test_sigterm_mid_stage_prints_one_line():
    env = {k: v for k, v in os.environ.items() if not k.startswith("OCPG_BENCH")}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.Popen([sys.executable, "-c", SIGTERM_CHILD], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        for line in proc.stderr:
            if line.startswith("STAGE"):
                break
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        proc.kill()
    lines = out.strip().splitlines()
    assert proc.returncode == 128 + signal.SIGTERM, err
    assert len(lines) == 1
    record = json.loads(lines[0])
    assert record["running_stage"] == "headline" and record["value"] == 0.0
    assert record["stage_wall_s"] == {} and "wall_s" in record


# ------------------------------------------------------------ bench_train --
@pytest.fixture
def small_train(monkeypatch):
    monkeypatch.setattr(bench_train, "train_config",
                        lambda args: small(dataset_file="ytvos", num_frames=args.frames))


def test_bench_train_timing_record(small_train, tmp_path):
    jsonl = tmp_path / "points.jsonl"
    argv = ["--device", "cpu", "--frames", "2", "--height", "64", "--width", "96",
            "--iters", "2", "--iters_short", "1", "--repeats", "1", "--trace",
            "--json_out", str(jsonl), "--out", str(tmp_path / "rec.json")]
    record = bench_train.main(argv)
    assert json.loads(jsonl.read_text().strip()) == record
    assert json.loads((tmp_path / "rec.json").read_text()) == record
    assert {"backbone", "batch", "frames", "height", "width", "step_ms",
            "train_frames_per_sec_per_chip", "train_mfu_dense", "train_mfu_incl_custom_calls",
            "gflop_per_step_dense", "gflop_per_step_kernels", "assumed_peak_tflops_bf16",
            "gpu_kind", "nvidia_smi", "steps", "launches"} <= set(record)
    assert record["steps"] == bench.WARMUP + 1 + 3 + 1 + 1     # + the traced step
    assert record["launches"] == dict.fromkeys(record["launches"], 0)   # no kernel on the CPU
    assert record["profile_device_ms_by_class"] is None     # no device time on the CPU
    assert record["step_ms"] > 0 and record["gflop_per_step_kernels"] > 0


def test_bench_train_overfit_and_e2e(small_train, tmp_path):
    common = ["--device", "cpu", "--frames", "2", "--height", "64", "--width", "96"]
    record = bench_train.main(common + ["--overfit", "3", "--out", str(tmp_path / "o.json")])
    assert record["steps"] == 3 and len(record["curve_every_10"]) == 1
    assert set(record) == {"backbone", "shape", "steps", "loss_first", "loss_min10",
                           "loss_last10", "curve_every_10", "converged"}
    record = bench_train.main(common + ["--e2e", "2", "--dataset", "davis", "--e2e_videos", "1",
                                        "--e2e_frames_per_video", "3", "--e2e_workers", "1",
                                        "--out", str(tmp_path / "e.json")])
    assert record["dataset"] == "davis" and record["steps"] == 2
    assert record["e2e_train_step_ms"] > 0 and record["resident_step_ms"] > 0
    assert np.isfinite(record["last_loss"])
