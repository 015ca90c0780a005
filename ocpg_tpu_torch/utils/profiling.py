"""Tracing and timing hooks: counterpart of ``ocpg_tpu/utils/profiling.py``.

``span(name)`` marks a layer boundary inside the program: while a
``torch.profiler`` profile is active it is a ``record_function`` range, so
the span lands in the profiler's Chrome trace beside the kernels, copies
and runtime calls, on the profiler's clock; with no profiler active it is
one shared no-op context and records nothing (about one C call: keep spans
out of per-element and per-parameter loops).  There is no switch: tracing
is on exactly while a profiler is, as under ``trace(logdir)`` below.
``span(name, keep=True)`` also appends the span's wall seconds to ``kept``
(always, profiler or not) for set-up phases that run before any profiler;
``kept_seconds(name)`` sums them.

``backward_span(name, device)`` is the span of a piece of the forward's
backward: made before the piece runs and handed the piece's outputs
(``enclose``), it puts two identity nodes into the autograd graph, one
after the piece that opens a ``record_function`` range when autograd
reaches it and one before the piece that closes it.  Autograd runs the
ready node made last first, so the range holds the backward of every
operation of the piece and of nothing made after it.  Like ``span()`` it
exists only while a profiler is active (and the forward records a graph):
otherwise it is None and the graph gains no node.

The spans, all named ``ocpg.*`` (no name holds another stage's name, so a
reader may match the stages by substring):

* ``engine/train.py::TrainStep``: ``ocpg.step`` (the call), inside it
  ``ocpg.step.upload``, ``ocpg.loss``, ``ocpg.backward``,
  ``ocpg.optim.clip``, ``ocpg.step.readback`` (the step's host sync) and
  ``ocpg.optim.step``;
* ``models/ocpg.py``: ``ocpg.forward``, inside it ``ocpg.backbone``,
  ``ocpg.text``, ``ocpg.fusion``, ``ocpg.transformer`` and ``ocpg.heads``
  (``ocpg.matcher`` inside the heads in training); in training also
  ``ocpg.grad.backbone``, the backbone's backward, on the thread that runs
  autograd's backward (``backward_span``);
* ``engine/infer.py::ClipInferenceEngine``: ``ocpg.engine.run`` (the
  call), per dispatch group ``ocpg.engine.dispatch`` (inside it
  ``ocpg.engine.assemble`` and ``ocpg.engine.upload``) and
  ``ocpg.engine.drain`` (inside it ``ocpg.engine.wait``);
* ``models/build.py::build_model``: ``ocpg.init``, kept.

Names carry no ids.  Spans of one request are tied by their order: with
one slot a dispatch group is one request, and the i-th
``ocpg.engine.dispatch`` and the i-th ``ocpg.engine.drain`` inside one
``ocpg.engine.run`` belong to its i-th group.

``trace(logdir)`` records the enclosed steps with ``torch.profiler`` (the
host and, on a GPU, the device) and writes a Chrome trace, viewable in
Perfetto or ``chrome://tracing``; ``StepTimer`` splits wall time between
waiting for data and the step; ``device_memory_stats`` reads the CUDA
allocator's peak and in-use memory per device.

The measurement helpers of ``chip_smoke.py`` and the bench drivers
(``ocpg_tpu_torch/scripts/bench*.py``), all on a GPU:

* ``cuda_times(fn, iters)``: device ms per call (the calls queue behind a
  sleep kernel, so CUDA events time the device, not the host's launch
  rate) and the host's enqueue ms per call; ``cuda_ms`` the first alone.
* ``profile_run(label, fn)``: ``fn()`` under ``torch.profiler``, device
  ms by kernel class (``KERNEL_CLASSES``, ``kernel_class``) and by
  kernel, and the device-busy share of the wall time.
* ``device_ms_under(events, name)``: the device ms of the kernels launched
  under the outermost CPU ranges so named.

The counters, module-level integers where the work happens (set them to 0
to reset), listed by ``LAUNCH_COUNTERS`` (the launches of the port's
kernels K1-K7; ``reset_launch_counts``, ``launch_counts``) and
``ENGINE_COUNTERS`` (the engine's real and dispatched pixels, and its
dispatches that ran the backbone or reused the previous group's).
"""

from __future__ import annotations

import contextlib
import importlib
import os
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

# one shared context for every span while no profiler is active
_NO_SPAN = contextlib.nullcontext()

# (name, wall seconds) of every kept span of this process, in order
kept: List[Tuple[str, float]] = []


@contextlib.contextmanager
def _kept_span(name: str) -> Iterator[None]:
    t0 = time.perf_counter()
    with span(name):
        yield
    kept.append((name, time.perf_counter() - t0))


def span(name: str, keep: bool = False):
    """A ``record_function`` range named ``name`` while a profiler is active,
    else the shared no-op; ``keep`` also appends its wall seconds to ``kept``."""
    if keep:
        return _kept_span(name)
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def kept_seconds(name: str) -> Optional[float]:
    """The summed wall seconds of the kept spans named ``name`` (None if none)."""
    secs = [s for n, s in kept if n == name]
    return sum(secs) if secs else None


class _BackwardSpanEnd(torch.autograd.Function):
    """Identity on an empty anchor, made before the piece: autograd reaches
    it after the piece's backward, and it closes the range."""

    @staticmethod
    def forward(ctx, state: List, anchor: torch.Tensor) -> torch.Tensor:
        ctx.state = state
        ctx.set_materialize_grads(False)
        return anchor.new_empty(0)

    @staticmethod
    def backward(ctx, grad):
        if ctx.state:
            ctx.state.pop().__exit__(None, None, None)
        return None, None


class _BackwardSpanBegin(torch.autograd.Function):
    """Identity on the piece's outputs: autograd reaches it once their
    gradients are summed, and it opens the range.  Its gradient to the end
    node is an empty tensor on the piece's device, so that node runs on the
    same autograd thread."""

    @staticmethod
    def forward(ctx, state: List, name: str, end: torch.Tensor, *outs: torch.Tensor):
        ctx.state, ctx.name, ctx.end = state, name, (end.dtype, end.device)
        ctx.set_materialize_grads(False)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        rf = torch.profiler.record_function(ctx.name)
        rf.__enter__()
        ctx.state.append(rf)
        dtype, device = ctx.end
        return (None, None, torch.empty(0, dtype=dtype, device=device), *grads)


class BackwardSpan:
    """See ``backward_span``."""

    def __init__(self, name: str, device):
        self.name = name
        self.state: List = []      # the open range, between the two nodes
        anchor = torch.empty(0, device=device, requires_grad=True)
        self.end = _BackwardSpanEnd.apply(self.state, anchor)

    def enclose(self, outs: List[torch.Tensor]) -> List[torch.Tensor]:
        """``outs`` through the opening node (those that take a gradient)."""
        idx = [i for i, x in enumerate(outs) if x.requires_grad]
        if not idx:
            return list(outs)
        marked = _BackwardSpanBegin.apply(self.state, self.name, self.end,
                                          *(outs[i] for i in idx))
        out = list(outs)
        for i, x in zip(idx, marked):
            out[i] = x
        return out


def backward_span(name: str, device) -> Optional[BackwardSpan]:
    """A ``BackwardSpan`` named ``name`` while a profiler is active and the
    forward records a graph, else None."""
    if torch._C._autograd._profiler_enabled() and torch.is_grad_enabled():
        return BackwardSpan(name, device)
    return None


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """Profile the enclosed code into ``<logdir>/trace.json`` (a no-op when
    logdir is None)."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Wall-clock iteration/data-time meters (the reference's MetricLogger
    iter and data times)."""

    def __init__(self):
        self.t_last = time.perf_counter()
        self.data_time = 0.0
        self.step_time = 0.0
        self.steps = 0

    def data_ready(self):
        now = time.perf_counter()
        self.data_time += now - self.t_last
        self._t_data = now

    def step_done(self):
        now = time.perf_counter()
        self.step_time += now - self._t_data
        self.t_last = now
        self.steps += 1

    def averages(self) -> Dict[str, float]:
        n = max(self.steps, 1)
        return {"data_time_s": self.data_time / n, "step_time_s": self.step_time / n}


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Per CUDA device, the allocator's peak and in-use memory in GiB (the
    reference's max-memory print); empty without a GPU."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        out[f"cuda:{i}"] = {
            "peak_gib": round(torch.cuda.max_memory_allocated(i) / 2**30, 3),
            "in_use_gib": round(torch.cuda.memory_allocated(i) / 2**30, 3),
        }
    return out


# cycles per second of torch.cuda._sleep's spin (an SM clock at or above the
# card's; a slower clock only lengthens the sleep)
SLEEP_CYCLES_PER_S = 2.0e9


def cuda_times(fn: Callable[[], object], iters: int, warmup: int = 3) -> Tuple[float, float]:
    """(device ms, host ms) per call of fn() over iters calls.  The calls
    queue up behind a sleep kernel that outlasts the host's enqueueing, so
    the CUDA events around them time the device, not the rate at which the
    host launches; the host's enqueue time per call is returned beside it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * once * iters + 1e-3, 2.0) * SLEEP_CYCLES_PER_S))
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def cuda_ms(fn: Callable[[], object], iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over iters launches (cuda_times)."""
    return cuda_times(fn, iters, warmup)[0]


KERNEL_CLASSES = (   # (class, substrings of CUDA kernel names), first match wins
    ("memcpy", ("memcpy",)),
    ("wattn", ("wattn_fwd",)),
    ("msda_cm_bwd", ("msda_bwd_kernel",)),
    ("msda", ("msda_fwd_kernel", "msda_r4_kernel", "msda_fk_kernel")),
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


def kernel_class(name: str) -> str:
    """The ``KERNEL_CLASSES`` class of a CUDA kernel name ("other" if none)."""
    low = name.lower()
    return next((c for c, keys in KERNEL_CLASSES if any(k in low for k in keys)), "other")


def profile_run(label: str, fn: Callable[[], object]) -> Optional[Dict]:
    """fn() under torch.profiler: device busy share and device time by
    kernel class and by kernel, printed.  Returns {"classes": device ms by
    class, "busy_ms": their sum, "wall_ms", "kernels": {name: (device ms,
    launches)}, "wattn_bwd_ms": the device ms of the kernels launched under
    K7's Function backward (its plain recompute)}, or None when the
    profiler recorded no device time (a CPU run)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
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
        print("profile: torch.profiler recorded no device time (not measured)", flush=True)
        return None
    classes: Dict[str, float] = {}
    for name, (ms, _) in by_kernel.items():
        cls = kernel_class(name)
        classes[cls] = classes.get(cls, 0.0) + ms
    launches = sum(n for _, n in by_kernel.values())
    print(f"profile: {label}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), {launches} kernel launches", flush=True)
    print("profile: device ms by class: " + ", ".join(
        f"{c} {ms:.2f}" for c, ms in sorted(classes.items(), key=lambda kv: -kv[1])),
        flush=True)
    for name, (ms, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"profile:   {ms:8.3f} ms  x{n:<5d} {name[:110]}", flush=True)
    return {"classes": classes, "busy_ms": busy_ms, "wall_ms": wall_ms, "kernels": by_kernel,
            "wattn_bwd_ms": device_ms_under(prof.events(), "WindowAttentionFunctionBackward")}


def device_ms_under(events, name_part: str) -> float:
    """Device ms of the kernels launched under the outermost CPU ranges
    whose name contains ``name_part`` (autograd's backward node of an
    autograd Function, whose nested backward runs inside it)."""
    def nested(ev):
        parent = ev.cpu_parent
        while parent is not None:
            if name_part in parent.name:
                return True
            parent = parent.cpu_parent
        return False

    us = 0.0
    for ev in events:
        if name_part in ev.name and not nested(ev):
            total = getattr(ev, "device_time_total", None)
            us += total if total is not None else getattr(ev, "cuda_time_total", 0)
    return us / 1e3


# launch counters of the port's kernels: (name, module, attribute)
LAUNCH_COUNTERS = (("K1", "ocpg_tpu_torch.ops.ms_deform_attn", "launches"),
                   ("K2", "ocpg_tpu_torch.ops.ms_deform_attn", "bwd_launches"),
                   ("K3", "ocpg_tpu_torch.ops.ms_deform_attn", "std_launches"),
                   ("K4", "ocpg_tpu_torch.ops.ms_deform_attn", "std_bwd_launches"),
                   ("K5", "ocpg_tpu_torch.ops.ms_deform_attn_variants", "r4_launches"),
                   ("K6", "ocpg_tpu_torch.ops.ms_deform_attn_variants", "fk_launches"),
                   ("K7", "ocpg_tpu_torch.ops.window_attention", "launches"))

# the engine's counters: frames x rows x columns of the requests it
# dispatched, and of the canvases it ran them on (slots x clip_len x bucket);
# its dispatches that ran the backbone, and that reused the previous group's
ENGINE_COUNTERS = (("pixels_real", "ocpg_tpu_torch.engine.infer", "pixels_real"),
                   ("pixels_dispatched", "ocpg_tpu_torch.engine.infer", "pixels_dispatched"),
                   ("backbone_runs", "ocpg_tpu_torch.engine.infer", "backbone_runs"),
                   ("backbone_reused", "ocpg_tpu_torch.engine.infer", "backbone_reused"))


def reset_counts(table) -> None:
    for _, module, attr in table:
        setattr(importlib.import_module(module), attr, 0)


def read_counts(table) -> Dict[str, int]:
    return {name: getattr(importlib.import_module(module), attr)
            for name, module, attr in table}


def reset_launch_counts() -> None:
    reset_counts(LAUNCH_COUNTERS)


def launch_counts() -> Dict[str, int]:
    return read_counts(LAUNCH_COUNTERS)
