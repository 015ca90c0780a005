"""Build and load the port's CUDA kernels.

Each source under ``ocpg_tpu_torch/ops/csrc`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface, in
``ocpg_tpu_torch/_build/`` (listed in ``.gitignore``), and loaded with
``ctypes``.  A library's file name carries a hash of its source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source builds anew.  Nothing is built when this module is imported:
the first launch builds its kernel, and ``build_all()`` builds every source
at once with one ``nvcc`` process per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "_build")
SOURCES = ("ms_deform_attn_fwd.cu", "ms_deform_attn_bwd.cu", "ms_deform_attn_r4.cu",
           "ms_deform_attn_fk.cu", "window_attention_fwd.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's output (register and spill counts from -Xptxas -v) per source
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): "
                           "the port's CUDA kernels are built on the GPU machine")
    return found


def _lib_path(source: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in [source] + sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh")):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()
    return os.path.join(BUILD_DIR, f"{os.path.splitext(source)[0]}_{digest[:16]}.so")


def _start(source: str) -> Optional[subprocess.Popen]:
    out = _lib_path(source)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _finish(source: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    build_logs[source] = log
    tmp = proc.args[proc.args.index("-o") + 1]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, _lib_path(source))


def build_all() -> float:
    """Build every kernel source in parallel; returns the seconds it took."""
    t0 = time.perf_counter()
    with _lock:
        procs = [(s, _start(s)) for s in SOURCES]
        for s, p in procs:
            _finish(s, p)
    return time.perf_counter() - t0


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, building it first if needed."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            _finish(source, _start(source))
            lib = ctypes.CDLL(_lib_path(source))
            _libs[source] = lib
        return lib
