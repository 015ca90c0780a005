"""Where the MSDA backward's (K2) time goes, on the GPU.

    python -m ocpg_tpu_torch.scripts.bench_msda_bwd

It takes no arguments and measures at the train encoder call (N=3,
S=Lq=6800, M=8, D=32, L=P=4, bf16 value):

* K2's kernel alone (no zero-fill, no cast) beside three variants of its
  source (``ops/csrc/ms_deform_attn_bwd.cu``) built without the d_value
  reductions (global and shared), without the corner gathers, and without
  both, on uniform and on clustered samples (``msda_inputs``);
* as many random 128-byte float32 row adds as K2 has corners there, three
  ways (``bench_msda_bwd.cu``): 16-byte global reductions (K2's way), scalar
  atomics into the distributed shared memory of a cluster of 8 CTAs that
  holds one map (the way a cluster design of K2 would add), and the same
  atomics into a CTA's own shared memory.

Device times from CUDA events.  It prints one line per reading and, last,
one JSON object with them and the card's name and power limit.  It needs a
GPU (exit 2 without one).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

from ocpg_tpu_torch.ops import _build
from ocpg_tpu_torch.ops import ms_deform_attn as msda

# the model's MSDA: heads, channels per head, points per level
HEADS, HEAD_DIM, POINTS = 8, 32, 4
# the train path: B=1 clip of T=3 frames at 512 x 640 -> levels at strides 8..64
TRAIN_SHAPES = ((64, 80), (32, 40), (16, 20), (8, 10))
TRAIN_N = 3
# the serving path: bucket 384 x 640, clip_len 5, one slot -> levels at strides 8..64
SERVE_SHAPES = ((48, 80), (24, 40), (12, 20), (6, 10))
SERVE_N = 5
# K2's variants: replacements in its source, each of which must match once
RED = "atomicAdd(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));"
SHARED_ADD = "atomicAdd(p, v);"
GATHER = ("__ldg(reinterpret_cast<const uint4*>(\n"
          "                                   v_nm + level_offset + row[c] * row_stride))")
NO_GATHER = "make_uint4(row[c], row[c] + 7u, row[c] * 3u, 1u)"
VARIANTS = {"no reds": ((RED, ""), (SHARED_ADD, "")),
            "no gathers": ((GATHER, NO_GATHER),),
            "neither": ((RED, ""), (SHARED_ADD, ""), (GATHER, NO_GATHER))}
SCATTER_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bench_msda_bwd.cu")
OUT_DIR = os.path.join(_build.BUILD_DIR, "bench_msda_bwd")
ROW_BYTES = 128


def msda_inputs(shapes, n, lq, dtype, seed, clustered=False):
    """MSDA inputs on the card.  Uniform (the default): locations in
    [-0.1, 1.1] (some outside the map), a quarter of the points on integer
    pixel coordinates.  Clustered (an encoder call, Lq = S): each query
    samples within +-2 pixels of its own reference point (the centre of its
    pixel in its level), as a trained encoder does, so that neighbouring
    queries gather and add into the same value rows; point 0 of each level
    lies on an integer pixel coordinate, and queries near a border sample
    outside the map.  Both put some samples at NaN or inf coordinates (a
    wholly padded frame has valid ratio 0, so the serving path gives the
    kernel NaN reference points)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    s = sum(h * w for h, w in shapes)
    l = len(shapes)
    dev = "cuda"
    value = torch.randn(n, s, HEADS, HEAD_DIM, generator=g, device=dev).to(dtype)
    if clustered:
        if lq != s:
            raise ValueError(f"clustered MSDA inputs are an encoder call's (Lq = S), got Lq={lq}")
        ref_x = torch.cat([((torch.arange(w, device=dev) + 0.5) / w).repeat(h)
                           for h, w in shapes])
        ref_y = torch.cat([((torch.arange(h, device=dev) + 0.5) / h).repeat_interleave(w)
                           for h, w in shapes])
        x = torch.empty(n, HEADS, l, POINTS, lq, device=dev)
        y = torch.empty(n, HEADS, l, POINTS, lq, device=dev)
        for lid, (h, w) in enumerate(shapes):
            off = torch.rand(2, n, HEADS, POINTS, lq, generator=g, device=dev) * 4 - 2
            x[:, :, lid] = ref_x + off[0] / w
            y[:, :, lid] = ref_y + off[1] / h
            x[:, :, lid, 0] = (torch.floor(x[:, :, lid, 0] * w) + 0.5) / w
            y[:, :, lid, 0] = (torch.floor(y[:, :, lid, 0] * h) + 0.5) / h
    else:
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


def _libraries():
    """K2's VARIANTS and the scatter-add source, one nvcc each, all started
    together, into OUT_DIR: {name: loaded library}."""
    with open(os.path.join(_build.CSRC, msda.BWD_SOURCE)) as f:
        text = f.read()
    os.makedirs(OUT_DIR, exist_ok=True)
    sources = {"scatter": SCATTER_SOURCE}
    for name, repl in VARIANTS.items():
        src = text
        for old, new in repl:
            if src.count(old) != 1:
                raise RuntimeError(f"K2 variant {name}: {old!r} is not once in "
                                   f"{msda.BWD_SOURCE}")
            src = src.replace(old, new)
        sources[name] = os.path.join(OUT_DIR, name.replace(" ", "_") + ".cu")
        with open(sources[name], "w") as f:
            f.write(src)
    procs = {name: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o",
         os.path.join(OUT_DIR, name.replace(" ", "_") + ".so"), path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, path in sources.items()}
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {sources[name]}:\n{out}")
        libs[name] = ctypes.CDLL(proc.args[proc.args.index("-o") + 1])
    return libs


def _device_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _launch(fn, *args):
    err = fn(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"launch failed: cudaError {err}")


def k2_split(libs) -> dict:
    """K2 and its VARIANTS at the train encoder call, uniform and clustered
    samples: {samples: {variant: ms}}."""
    entries = {"full": msda._kernel(msda.BWD_SOURCE, "msda_cm_bwd", 9)}
    for name in VARIANTS:
        fn = libs[name].msda_cm_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.POINTER(ctypes.c_int)] * 2
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        entries[name] = fn
    lq = sum(h * w for h, w in TRAIN_SHAPES)
    split = {}
    for samples in ("uniform", "clustered"):
        value, x, y, aw = msda_inputs(TRAIN_SHAPES, TRAIN_N, lq, torch.bfloat16, seed=7,
                                      clustered=samples == "clustered")
        g = torch.randn(TRAIN_N, lq, HEADS * HEAD_DIM, generator=torch.Generator(
            device="cuda").manual_seed(9), device="cuda").to(torch.bfloat16)
        d_value = torch.zeros(value.shape, dtype=torch.float32, device="cuda")
        grads = [torch.empty_like(x) for _ in range(3)]
        split[samples] = {name: _device_ms(lambda: msda._call(
            fn, f"K2 {name}", value, TRAIN_SHAPES, POINTS, lq,
            (value, x, y, aw, g, d_value, *grads)), 20) for name, fn in entries.items()}
        print(f"K2 train encoder, {samples} samples, kernel alone (ms): " + ", ".join(
            f"{k} {v:.4f}" for k, v in split[samples].items()), flush=True)
    return split


def scatter_rates(lib) -> dict:
    """As many random 128-byte float32 row adds as K2 has corners at the
    train encoder call, into N x M maps of S rows, three ways:
    {way: {rows, ms, tb_per_s}}."""
    s = sum(h * w for h, w in TRAIN_SHAPES)
    maps = TRAIN_N * HEADS
    corner_rows = maps * s * len(TRAIN_SHAPES) * POINTS * 4
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.scatter_global_run.argtypes = [ptr, i32, i32, i32, i32, ptr]
    lib.scatter_cluster_run.argtypes = [ptr, i32, i32, i32, i32, i32, ptr]
    lib.scatter_cluster_max_active.argtypes = [i32, i32, ctypes.POINTER(i32)]
    result = {}
    scratch = torch.zeros(maps * s * 32, device="cuda")
    threads = 256
    blocks = torch.cuda.get_device_properties(0).multi_processor_count * 2048 // threads
    iters = max(1, corner_rows // (blocks * threads // 4))
    rows = blocks * threads // 4 * iters
    ms = _device_ms(lambda: _launch(lib.scatter_global_run, scratch.data_ptr(), maps * s,
                                    blocks, threads, iters), 10)
    result["global"] = dict(rows=rows, ms=ms, tb_per_s=rows * ROW_BYTES / ms / 1e9)
    out = torch.zeros(8 * 1024, device="cuda")
    threads = 1024
    n = ctypes.c_int(0)
    err = lib.scatter_cluster_max_active(s, threads, ctypes.byref(n))
    if err != 0 or n.value < 1:
        raise RuntimeError(f"no cluster fits: cudaError {err}, {n.value} clusters")
    iters = max(1, corner_rows // (n.value * 8 * threads // 4))
    rows = n.value * 8 * threads // 4 * iters
    for name, remote in (("cluster", 1), ("shared", 0)):
        ms = _device_ms(lambda: _launch(lib.scatter_cluster_run, out.data_ptr(), s, n.value,
                                        threads, iters, remote), 10)
        result[name] = dict(rows=rows, ms=ms, tb_per_s=rows * ROW_BYTES / ms / 1e9,
                            clusters=n.value)
    for name, r in result.items():
        print(f"scatter-add {name}: {r['rows']} rows of {ROW_BYTES} B in {r['ms']:.4f} ms "
              f"= {r['tb_per_s']:.2f} TB/s", flush=True)
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_msda_bwd: no CUDA device", file=sys.stderr)
        return 2
    libs = _libraries()
    result = {"k2_split": k2_split(libs), "scatter": scatter_rates(libs["scatter"])}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi.stdout.strip().splitlines()[0] if smi.stdout else None,
                      **result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
