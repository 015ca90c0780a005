"""Where the dense-row (K5) and fused-K (K6) MSDA forwards' time goes, on
the GPU.

    python -m ocpg_tpu_torch.scripts.bench_msda_dense

It takes no arguments and measures at the serving and train encoder calls
(N=5, S=Lq=5100 and N=3, S=Lq=6800; M=8, D=32, L=P=4; bf16 value), on
uniform and on clustered samples (``bench_msda_bwd.msda_inputs``, seed 7),
each kernel alone beside variants of its source built with a part taken
out:

* K5 (``ops/csrc/ms_deform_attn_r4.cu``): without its wgmma products, and
  without writing the M tiles' entries (the products then run on zeros);
* K6 (``ops/csrc/ms_deform_attn_fk.cu``): without its wgmma products.

What is left when a part is taken out (the copies, barriers, waits and
set-up) is the kernel's skeleton; the difference to the full kernel is that
part's share.  Device times from CUDA events.  It prints one line per
reading and, last, one JSON object with them and the card's name and power
limit.  It needs a GPU (exit 2 without one).
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
from ocpg_tpu_torch.ops import ms_deform_attn_variants as msda_var
from ocpg_tpu_torch.scripts.bench_msda_bwd import (POINTS, SERVE_N, SERVE_SHAPES, TRAIN_N,
                                                   TRAIN_SHAPES, _device_ms, msda_inputs)

R4_PRODUCTS = """#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
#pragma unroll
        for (int u = 0; u < kSub; ++u)
          Wgmma<D>::mma(acc[u], wgmma_desc_a_sw32(a0 + kk * kWgRows * 32 + u * 64 * 32),
                        wgmma_desc_b_mn<D>(b0 + kk * 16 * D * 2), 1);
      }"""
R4_ENTRIES = """      for (int e = off[c] + wt; e < off[c + 1]; e += 128) {
        const uint32_t v = ent[e];
        *reinterpret_cast<unsigned short*>(mb + m_offset(v >> 22, (v >> 16) & 63)) =
            static_cast<unsigned short>(v & 0xffffu);
      }"""
FK_PRODUCTS = """              Wgmma<D>::mma(acc[j], wgmma_desc_a_sw32(a),
                            wgmma_desc_b_mn<D>(b0 + (j * kw + s * 16) * D * 2), s > 0);"""
# {variant: (source, symbol, [(text, replacement)])}
VARIANTS = {
    "K5 without products": (msda_var.R4_SOURCE, "msda_cm_r4_fwd",
                            [(R4_PRODUCTS, "      (void)a0;\n      (void)b0;")]),
    "K5 without M entries": (msda_var.R4_SOURCE, "msda_cm_r4_fwd",
                             [(R4_ENTRIES, "")]),
    "K6 without products": (msda_var.FK_SOURCE, "msda_cm_fk_fwd",
                            [(FK_PRODUCTS, "              (void)a;")]),
}
OUT_DIR = os.path.join(_build.BUILD_DIR, "bench_msda_dense")


def _libraries():
    """The VARIANTS, one nvcc each, all started together, into OUT_DIR:
    {name: loaded library}."""
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name, (source, _, repl) in VARIANTS.items():
        with open(os.path.join(_build.CSRC, source)) as f:
            text = f.read()
        for old, new in repl:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not once in {source}")
            text = text.replace(old, new)
        stem = os.path.join(OUT_DIR, name.replace(" ", "_"))
        with open(stem + ".cu", "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", stem + ".so",
             stem + ".cu"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        libs[name] = ctypes.CDLL(proc.args[proc.args.index("-o") + 1])
    return libs


def split(libs) -> dict:
    """Each kernel and its variants at the two encoder calls, uniform and
    clustered samples: {call: {kernel or variant: ms}}."""
    entries = {"K5": msda._kernel(msda_var.R4_SOURCE, "msda_cm_r4_fwd", 5),
               "K6": msda._kernel(msda_var.FK_SOURCE, "msda_cm_fk_fwd", 5)}
    for name, (_, symbol, _) in VARIANTS.items():
        fn = getattr(libs[name], symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_int)] * 2
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        entries[name] = fn
    result = {}
    for call, shapes, n in (("serve encoder", SERVE_SHAPES, SERVE_N),
                            ("train encoder", TRAIN_SHAPES, TRAIN_N)):
        lq = sum(h * w for h, w in shapes)
        for samples in ("uniform", "clustered"):
            value, x, y, aw = msda_inputs(shapes, n, lq, torch.bfloat16, seed=7,
                                          clustered=samples == "clustered")
            out = torch.empty((n, lq, value.shape[2] * value.shape[3]), dtype=value.dtype,
                              device="cuda")
            tag = f"{call} {samples}"
            result[tag] = {name: _device_ms(lambda: msda._call(
                fn, name, value, shapes, POINTS, lq, (value, x, y, aw, out)), 20)
                for name, fn in entries.items()}
            print(f"{tag} (ms): " + ", ".join(f"{k} {v:.4f}" for k, v in result[tag].items()),
                  flush=True)
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_msda_dense: no CUDA device", file=sys.stderr)
        return 2
    result = split(_libraries())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi.stdout.strip().splitlines()[0] if smi.stdout else None,
                      "split": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
