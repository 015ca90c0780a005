"""The port's measurement drivers (``ocpg_tpu_torch/scripts/bench_*.py``)
and the profiling helpers on the CPU, against the JAX scripts of
``scripts/`` (loaded from their files, never edited, never run whole:
they would write their records at the repo root).

* The trees: ``bench_eval_e2e.build_a2d_tree`` and ``bench_loader.
  build_tree`` write the JAX scripts' files at the same sizes: the mp4
  (cv2), PNG and JPEG (PIL) and JSON files byte for byte, the h5 files
  (the port's writer, where the JAX scripts use h5py) as h5py reads them:
  names, dtypes, shapes and values (an HDF5 file's bytes belong to the
  library that wrote it); the Ref-DAVIS and JHMDB trees read back
  through the port's loaders; with h5py blocked the three drivers run
  their default trees (Ref-YTVOS, A2D) at test sizes.
* ``bench_serving.request_pool`` is the JAX script's pool (its statements
  run here on the same arguments).
* ``bench_train_sweep``: the JAX sweep's defaults and grid order (its loop
  run here with a stand-in for the point), and an out-of-memory row from a
  fake child process, with the larger batches at its T skipped.
* ``utils/profiling``: ``kernel_class`` on a table of CUDA kernel names;
  ``profile_run`` on the CPU reports no device time.
* ``bench_swin_micro``: its serving calls are the JAX Swin's windows and
  masks, and its window-attention parts (K7's dispatcher, the plain
  version, SDPA) and bias layouts agree.
"""
import argparse
import ast
import functools
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ocpg_tpu.models import backbone_video_swin as jax_swin

from ocpg_tpu_torch import config
from ocpg_tpu_torch.config import OCPGConfig
from ocpg_tpu_torch.data import loader as loader_module
from ocpg_tpu_torch.data.datasets import build_dataset
from ocpg_tpu_torch.data.loader import ClipLoader
from ocpg_tpu_torch.scripts import (bench_eval_e2e, bench_loader, bench_serving,
                                    bench_swin_micro, bench_train, bench_train_sweep)
from ocpg_tpu_torch.utils import profiling

from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
# a small model for the drivers' runs on the CPU
TINY = dict(backbone="resnet50", enc_layers=1, dec_layers=2, dim_feedforward=64, num_queries=5,
            text_layers=2, text_hidden=128, text_heads=4, text_ffn=256, text_vocab=1000,
            text_max_pos=40)


def jax_script(name):
    """A JAX script of ``scripts/`` as a module, loaded from its file."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_main_body(name):
    tree = ast.parse((REPO / "scripts" / f"{name}.py").read_text())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main").body


def jax_defaults(name):
    """``{flag: default}`` of the add_argument calls in a JAX script's main."""
    out = {}
    for node in ast.walk(ast.Module(body=jax_main_body(name), type_ignores=[])):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            flag = node.args[0].value.lstrip("-").replace("-", "_")
            for kw in node.keywords:
                if kw.arg == "default":
                    out[flag] = ast.literal_eval(kw.value)
    return out


def files_of(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def h5py_datasets(path):
    """Every dataset of an h5 file as h5py reads it: {name: (dtype, shape,
    bytes)}."""
    import h5py

    with h5py.File(path, "r") as f:
        return {k: (f[k].dtype, f[k].shape, np.asarray(f[k][()]).tobytes()) for k in f}


def assert_same_tree(got_root, want_root):
    """The files of two trees: h5 files equal as h5py reads them (kept equal
    byte for byte where the bytes agree), every other file byte for byte."""
    want, got = files_of(want_root), files_of(got_root)
    assert list(got) == list(want)
    for k in want:
        if k.endswith(".h5") and got[k] != want[k]:
            assert h5py_datasets(got_root / k) == h5py_datasets(want_root / k), k
        else:
            assert got[k] == want[k], k
    return want


# ------------------------------------------------------------------ trees --
def test_a2d_tree_is_the_jax_scripts_byte_for_byte(tmp_path):
    jax_script("bench_eval_e2e").build_a2d_tree(str(tmp_path / "jax"), 2, 4)
    bench_eval_e2e.build_a2d_tree(str(tmp_path / "port"), 2, 4)
    want = assert_same_tree(tmp_path / "port", tmp_path / "jax")
    assert len(want) == 2 * 2 + 2 and sum(k.endswith(".h5") for k in want) == 2


def test_loader_tree_is_the_jax_scripts_byte_for_byte(tmp_path):
    jax_script("bench_loader").build_tree(str(tmp_path / "jax"), 2, 3, 72, 128)
    bench_loader.build_tree(str(tmp_path / "port"), 2, 3, 72, 128)
    want = assert_same_tree(tmp_path / "port", tmp_path / "jax")
    assert len(want) == 2 * 3 * 3 + 1 and sum(k.endswith(".h5") for k in want) == 2 * 3
    # the Ref-DAVIS tree: the same files without the h5 heatmaps
    bench_loader.build_tree(str(tmp_path / "davis"), 2, 3, 72, 128, dataset="davis")
    davis = files_of(tmp_path / "davis")
    assert davis == {k: v for k, v in want.items() if "AnnotationsWeakly" not in k}


def test_davis_and_jhmdb_trees_read_back(tmp_path):
    bench_loader.build_tree(str(tmp_path / "davis"), 2, 4, 72, 128, dataset="davis")
    ds = build_dataset("davis", str(tmp_path / "davis"), "train", 3, "box")
    loader = ClipLoader(ds, 1, canvas=(64, 96), train=True, num_workers=1, text_vocab=1000)
    assert bench_loader.batches_per_sec(loader, 1) > 0
    bench_eval_e2e.build_jhmdb_tree(str(tmp_path / "jhmdb"), 3, 6)
    ds = build_dataset("jhmdb", str(tmp_path / "jhmdb"), "val", 3)
    assert len(ds) == 3


def test_default_datasets_run_without_h5py(monkeypatch, tmp_path):
    """The three drivers' default trees (Ref-YTVOS with heatmaps, A2D) are
    written and read by the port's h5 module: with h5py blocked each runs
    at a test size."""
    monkeypatch.setitem(sys.modules, "h5py", None)      # import h5py raises ImportError
    rec = bench_loader.main(["--videos", "1", "--frames-per-video", "3", "--batches", "2",
                             "--workers", "1", "--out", ""])
    assert rec["dataset"] == "ytvos" and rec["value"] > 0
    # the small model on 64 x 96 clips and canvases
    monkeypatch.setattr(config, "a2d_r101_boxsup",
                        lambda: OCPGConfig(**TINY, dataset_file="a2d", num_frames=3))
    monkeypatch.setattr(bench_eval_e2e, "H", 64)
    monkeypatch.setattr(bench_eval_e2e, "W", 96)
    monkeypatch.setattr(loader_module, "canvas_for", lambda: (64, 96))
    rec = bench_eval_e2e.main(["--device", "cpu", "--videos", "2", "--frames", "4",
                               "--resident_iters", "1", "--out", ""])
    assert rec["dataset"] == "a2d" and rec["clips"] == 2 and rec["metrics_finite"]
    monkeypatch.setattr(bench_train, "train_config", lambda args: OCPGConfig(
        **TINY, dataset_file="ytvos", num_frames=args.frames, compute_dtype="float32"))
    rec = bench_train.main(["--device", "cpu", "--e2e", "2", "--e2e_videos", "1",
                            "--e2e_frames_per_video", "3", "--e2e_workers", "1",
                            "--frames", "2", "--height", "64", "--width", "96", "--out", ""])
    assert rec["dataset"] == "ytvos" and rec["steps"] == 2 and np.isfinite(rec["last_loss"])


# ---------------------------------------------------------------- serving --
def test_request_pool_is_the_jax_scripts():
    args = argparse.Namespace(reqs=3, frames=4, height=24, width=40)
    body = jax_main_body("bench_serving")
    start = next(i for i, n in enumerate(body)
                 if isinstance(n, ast.Assign) and ast.unparse(n).startswith("rng ="))
    loop = next(i for i, n in enumerate(body) if isinstance(n, ast.For) and i > start)
    code = compile(ast.Module(body=body[start:loop + 1], type_ignores=[]), "jax_pool", "exec")
    scope = {"np": np, "args": args, "InferRequest": lambda *a: a}
    exec(code, scope)
    got = bench_serving.request_pool(args.reqs, args.frames, args.height, args.width)
    assert len(got) == len(scope["reqs"]) == 3
    for g, (frames, ids, mask) in zip(got, scope["reqs"]):
        assert g.frames.dtype == frames.dtype == np.uint8 and np.array_equal(g.frames, frames)
        assert np.array_equal(g.text_ids, ids) and np.array_equal(g.text_mask, mask)
        assert g.text_ids.dtype == ids.dtype and g.query_override == -1
    assert vars(bench_serving.get_args([])).items() >= {
        k: v for k, v in jax_defaults("bench_serving").items()}.items()


# ------------------------------------------------------------------ sweep --
def test_sweep_defaults_and_grid_are_the_jax_scripts():
    defaults = jax_defaults("bench_train_sweep")
    args = bench_train_sweep.get_args([])
    assert {k: getattr(args, k) for k in defaults} == defaults
    # the JAX loop with a stand-in point: ok, except batch 2 at T=3 runs out of memory
    body = jax_main_body("bench_train_sweep")
    loop = next(n for n in body if isinstance(n, ast.For))
    seen = []

    def point(backbone, batch, frames, height, width, **kw):
        seen.append((backbone, frames, batch))
        return {"backbone": backbone, "batch": batch, "frames": frames,
                "status": "oom" if (batch, frames) == (2, 3) else "ok"}

    scope = {"args": argparse.Namespace(**defaults), "run_point": point, "json": json,
             "upsert": lambda rec: None, "write_artifact": lambda: None, "print": lambda *a, **k: None}
    exec(compile(ast.Module(body=[loop], type_ignores=[]), "jax_sweep", "exec"), scope)
    want = list(seen)
    seen.clear()
    args.out = ""
    artifact = bench_train_sweep.sweep(args, run=point)
    assert seen == want and len(want) == 2 * (2 + 3)
    assert [(p["backbone"], p["frames"], p["batch"]) for p in artifact["points"]] == want
    assert list(bench_train_sweep.grid(["a"], [3, 5], [1, 2])) == [
        ("a", 3, 1), ("a", 3, 2), ("a", 5, 1), ("a", 5, 2)]


FAKE_CHILD = """
import argparse, json, sys
ap = argparse.ArgumentParser()
for flag in ("--backbone", "--batch", "--frames", "--height", "--width", "--json_out", "--out",
             "--iters", "--iters_short", "--repeats"):
    ap.add_argument(flag)
args = ap.parse_args()
if int(args.batch) >= 2:
    print("Traceback (most recent call last):", file=sys.stderr)
    print("torch.OutOfMemoryError: CUDA out of memory. Tried to allocate 9.00 GiB",
          file=sys.stderr)
    sys.exit(1)
if int(args.frames) == 7:
    print("some other fault", file=sys.stderr)
    sys.exit(3)
with open(args.json_out, "a") as f:
    f.write(json.dumps({"step_ms": 100.0 * int(args.frames), "iters": args.iters}) + "\\n")
"""


def test_sweep_records_an_out_of_memory_row_from_a_fake_child(tmp_path):
    fake = tmp_path / "fake_bench_train.py"
    fake.write_text(FAKE_CHILD)
    out = tmp_path / "points.json"
    run = functools.partial(bench_train_sweep.run_point, child=[sys.executable, str(fake)])
    args = bench_train_sweep.get_args(["--backbones", "resnet101", "--frames", "3", "7",
                                       "--iters", "5", "--out", str(out)])
    artifact = bench_train_sweep.sweep(args, run=run)
    assert json.loads(out.read_text()) == artifact
    rows = {(p["frames"], p["batch"]): p for p in artifact["points"]}
    assert sorted(rows) == [(3, 1), (3, 2), (7, 1), (7, 2)]     # batch 4 after an OOM: skipped
    assert rows[3, 1]["status"] == "ok" and rows[3, 1]["step_ms"] == 300.0
    assert rows[3, 1]["iters"] == "5" and rows[3, 1]["wall_s"] >= 0
    assert rows[3, 2]["status"] == "oom" and "OutOfMemoryError" in rows[3, 2]["stderr_tail"]
    assert rows[7, 1]["status"] == "failed(rc=3)" and rows[7, 2]["status"] == "oom"
    # a second run keeps the finished points and drops the failed one
    args = bench_train_sweep.get_args(["--backbones", "other", "--frames", "3",
                                       "--batches", "1", "--out", str(out)])
    artifact = bench_train_sweep.sweep(args, run=run)
    assert sorted((p["backbone"], p["frames"], p["batch"]) for p in artifact["points"]) == [
        ("other", 3, 1), ("resnet101", 3, 1), ("resnet101", 3, 2), ("resnet101", 7, 2)]


# -------------------------------------------------------------- profiling --
@pytest.mark.parametrize("name, cls", [
    ("void msda_fwd_kernel<__nv_bfloat16, 8>(MsdaParams)", "msda"),
    ("msda_bwd_kernel<float, 4>", "msda_cm_bwd"),
    ("msda_r4_kernel", "msda"),
    ("msda_fk_kernel<64>", "msda"),
    ("void wattn_fwd_bf16<32>(...)", "wattn"),
    ("Memcpy HtoD (Pinned -> Device)", "memcpy"),
    ("void fft_r2c_kernel", "fft"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "conv"),
    ("cudnn::bn_fw_inf_1C11_kernel_NCHW", "conv"),
    ("nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NNN", "gemm"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "gemm"),
    ("void multi_tensor_apply_kernel<TensorListMetadata<4>, AdamFunctor<float>>", "optimizer"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel", "norm"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float>", "softmax"),
    ("void at::native::upsample_bilinear2d_out_frame", "resize"),
    ("void at::native::index_elementwise_kernel<128, 4>", "gather/scatter"),
    ("void at::native::elementwise_kernel<128, 2>(copy_)", "copy/cast"),
    ("void at::native::unrolled_elementwise_kernel<direct_copy_kernel_cuda>", "copy/cast"),
    ("void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add<float>>",
     "elementwise/reduce"),
    ("void at::native::reduce_kernel<512, 1>", "elementwise/reduce"),
    ("some_unknown_kernel", "other"),
])
def test_kernel_classes(name, cls):
    assert profiling.kernel_class(name) == cls


def test_profile_run_on_the_cpu_reports_no_device_time():
    assert profiling.profile_run("cpu", lambda: torch.ones(4) @ torch.ones(4)) is None


# ------------------------------------------------------------- swin micro --
def test_swin_micro_serving_calls_are_the_jax_swins():
    for stage, bw, heads, n, mask in bench_swin_micro.serving_calls():
        dims = (bench_swin_micro.SWIN_T,) + bench_swin_micro.SWIN_GRIDS[stage]
        window = bench_swin_micro.SWIN_WINDOW
        ws, ss = jax_swin._get_window_size(dims, window, tuple(w // 2 for w in window))
        pads = [-(-d // w) * w for d, w in zip(dims, ws)]
        want = np.asarray(jax_swin._sw_attn_mask(*pads, ws, ss))
        assert (heads, n) == (4 * 2 ** stage, 245) and np.array_equal(mask, want)
        assert bw == want.shape[0]
    assert [c[1] for c in bench_swin_micro.serving_calls()] == [322, 84, 24, 6]
    assert bench_swin_micro.BIAS_TABLE_ROWS == len(np.unique(jax_swin._relative_position_index(
        (8, 7, 7))))


def test_swin_micro_attention_parts_agree():
    call = (0,) + bench_swin_micro.swin_call((8, 12), 2, window=(2, 4, 4), frames=2)
    outs = [fn().float() for _, fn in bench_swin_micro.attention_parts(
        "cpu", calls=[call], dtype=torch.float32)]
    assert len(outs) == 3 and outs[0].shape == (call[1], call[3], 2, 32)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    torch.testing.assert_close(outs[2], outs[1], rtol=1e-5, atol=1e-5)


def test_swin_micro_layout_parts_agree():
    rng = np.random.default_rng(0)
    current, direct = (fn() for _, fn in bench_swin_micro.bias_parts("cpu", rng, heads=3, n=7))
    assert torch.equal(current, direct)
    x = torch.randn(1, 5, 28, 42, 512)
    torch.testing.assert_close(bench_swin_micro.partition_reverse(x), x * 1.0001)
