"""The frozen reference against the program at a tiny configuration on the
CPU, and what the harness and the reference import."""

import os
import subprocess
import sys
import time

import pytest

from benchmark import manifest, run
from benchmark.tests.conftest import DATA, ROOT


def drive(workload, seed=2**31 + 17, seconds=0.2, trace=0):
    args = run.parse(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                      "--trace", str(trace)])
    return run.run_cell(args, device="cpu", root=DATA, base=DATA, t0=time.perf_counter())


@pytest.mark.parametrize("workload", ["f32_train", "f32_swin_train", "f32_swin2d_train"])
def test_reference_train_step_is_the_programs(workload):
    """The program in float32 on the CPU, on the same weights, batches and
    dropout draws, takes the reference's three steps (run in blocks of rows)
    to round-off; AdamW's first steps turn the round-off of gradients near
    zero into whole steps of a few elements, so the change reads higher."""
    out = drive(workload)
    vals = {k: v["value"] for k, v in out["checks"].items()}
    assert out["correct"] and vals["loss_gap"] < 1e-4 and vals["change_gap"] < 1e-2, vals
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"train_clips_per_s", "setup_s"}


@pytest.mark.parametrize("workload", ["f32_train"])
def test_reference_gradients_are_the_programs(workload):
    from benchmark import calibrate, generate

    cell = manifest.find_cell(manifest.load_json(DATA + "/BENCHMARK.json"), workload, DATA)
    runner = manifest.work_module("clips")
    seed = 31
    fields = runner.model_fields(cell, seed)
    pool = generate.make_clips(cell.traffic, seed, "cpu")
    prog = runner.program_readings(runner.build_program(fields, seed, "cpu"), pool, fields,
                                   seed, "cpu")
    ref = runner.reference_readings(fields, seed, pool, "cpu")
    look = calibrate.look_numbers(prog, ref)
    assert look["grad_gap_worst"] < 1e-3 and look["total_loss_gap"] < 1e-5, look


@pytest.mark.parametrize("workload", ["f32_infer", "f32_swin_infer", "f32_swin2d_infer"])
def test_reference_serving_is_the_programs(workload):
    out = drive(workload)
    vals = {k: v["value"] for k, v in out["checks"].items()}
    assert out["correct"] and vals["mask_gap"] < 1e-5, vals
    assert set(out["metrics"]) == {"infer_frames_per_s", "infer_request_p95_ms", "setup_s"}


@pytest.mark.parametrize("workload", ["f32_swin_train", "f32_swin_infer"])
def test_a_traced_run_reads_its_layers(workload):
    """A ``--trace 1`` run on the CPU: the host spans, the MFU and the
    breakdown are read; the device's metrics find nothing to read there."""
    out = drive(workload, trace=1)
    kind = "train" if "train" in workload else "infer"
    host = {"train": "step_host_ms.train", "infer": "forward_host_ms.infer"}[kind]
    assert out["correct"] and host in out["metrics"] and f"mfu.{kind}" in out["metrics"]
    assert not any(m.startswith(("idle_share", "msda_roofline", "wattn_roofline"))
                   for m in out["metrics"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert 0 < out["metrics"][f"mfu.{kind}"]["value"] < 100


FORBIDDEN = ("jax", "jaxlib", "flax", "ocpg_tpu")


def _loaded_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted("
                          "{m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_the_reference_loads_nothing_of_the_program_or_jax():
    """Also once every backbone module the lookup finds is loaded and each of
    its backbones built."""
    loaded = _loaded_after("import torch, benchmark.reference.step, benchmark.reference.lowp, "
                           "benchmark.weights, benchmark.check, benchmark.counts\n"
                           "from benchmark.reference.config import OCPGConfig\n"
                           "from benchmark.reference.ocpg import backbone_table\n"
                           "table = backbone_table()\n"
                           "assert 'swin_l_p4w7' in table\n"
                           "with torch.device('meta'):\n"
                           "    for name, build in table.items():\n"
                           "        build(OCPGConfig(backbone=name))")
    assert not loaded & {*FORBIDDEN, "ocpg_tpu_torch"}, loaded


def test_a_run_loads_no_jax():
    """A whole run, in a fresh process, leaves no JAX, jaxlib, flax or JAX
    package in ``sys.modules`` (top-level names compared whole)."""
    code = ("import time, torch\ntorch.set_num_threads(2)\nfrom benchmark import run\n"
            f"a = run.parse(['--workload', 'f32_infer', '--seed', '3', '--seconds', '0.1'])\n"
            f"run.run_cell(a, device='cpu', root={DATA!r}, base={DATA!r}, t0=time.perf_counter())\n"
            "assert not run.forbidden_modules(), run.forbidden_modules()")
    loaded = _loaded_after(code)
    assert "ocpg_tpu_torch" in loaded and not loaded & set(FORBIDDEN), loaded


def test_forbidden_names_are_compared_whole():
    sys.modules.setdefault("ocpg_tpu_torch_like_fake", sys)
    try:
        assert "ocpg_tpu" not in run.forbidden_modules()
    finally:
        del sys.modules["ocpg_tpu_torch_like_fake"]


def test_no_card_no_result(capsys):
    """Without a CUDA card the command prints no result and exits non-zero."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", manifest.load_manifest()["workloads"][0]["name"],
                   "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


@pytest.mark.card
def test_a_cell_runs_on_the_card(card):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "r101_infer_ytvos", "--seed", str(2**31 + 3), "--seconds", "5"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    import json

    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and list(res)[-1] == "checks"
