"""The traced span of a ``--trace 1`` run: the benchmark's own spans around
the calls into each layer, a ``torch.profiler`` trace of a short span, and
its reduction to what the per-layer metrics read.

``Tracer`` wraps a callable of the timed path (``record_function`` spans
with the benchmark's names, forward hooks on a module) and records the
shapes of the MSDA and window-attention calls by wrapping the program's
module attributes that its layers call; ``profile`` runs a function under
the profiler and returns a ``Trace``.

A ``Trace`` holds, in microseconds on the profiler's clock, the device
operations (kernels, copies, sets), the host's runtime calls, the
benchmark's spans and the program's CPU ops, read from the exported
Chrome trace (written under ``TMPDIR`` and deleted).  Busy time is the
union of the device operations' intervals, not their sum.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

Interval = Tuple[float, float]


def union_length(intervals: List[Interval]) -> float:
    """Total length covered by ``intervals`` (start, end)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: List[Interval], start: float, end: float) -> List[Interval]:
    """The stretches of [start, end] that no interval covers."""
    out, cur = [], start
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, end)))
        cur = max(cur, e)
        if cur >= end:
            break
    if cur < end:
        out.append((cur, end))
    return [g for g in out if g[1] > g[0]]


@dataclass
class Event:
    name: str
    ts: float
    dur: float
    tid: int = 0
    corr: Optional[int] = None

    @property
    def end(self) -> float:
        return self.ts + self.dur


@dataclass
class Trace:
    start: float
    end: float
    device: List[Event] = field(default_factory=list)      # kernels, copies, sets
    kernels: List[Event] = field(default_factory=list)
    copies: List[Event] = field(default_factory=list)
    runtime: List[Event] = field(default_factory=list)
    spans: List[Event] = field(default_factory=list)       # the benchmark's spans
    ops: List[Event] = field(default_factory=list)         # the program's CPU ops

    @property
    def wall_us(self) -> float:
        return self.end - self.start

    def busy_us(self) -> float:
        return union_length([(e.ts, e.end) for e in self.device])

    def kernel_us(self, part: str) -> float:
        return sum(e.dur for e in self.kernels if part in e.name)

    def spans_named(self, name: str) -> List[Event]:
        return [e for e in self.spans if e.name == name]

    def sync_us_within(self, outer: List[Event]) -> float:
        """Host time blocked in CUDA synchronisation inside the spans ``outer``."""
        total = 0.0
        for e in self.runtime:
            if "Synchronize" not in e.name:
                continue
            for o in outer:
                if o.tid == e.tid and o.ts <= e.ts and e.end <= o.end:
                    total += e.dur
                    break
        return total

    def device_us_under(self, op_part: str) -> float:
        """Device time of the operations launched inside the CPU ops whose name
        holds ``op_part`` (on their thread), matched by correlation id."""
        outer = [o for o in self.ops if op_part in o.name]
        corrs = set()
        for e in self.runtime:
            if e.corr is None:
                continue
            for o in outer:
                if o.tid == e.tid and o.ts <= e.ts and e.end <= o.end:
                    corrs.add(e.corr)
                    break
        return sum(d.dur for d in self.device if d.corr in corrs)

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        by: Dict[str, float] = {}
        for e in self.device:
            by[e.name] = by.get(e.name, 0.0) + e.dur
        return [(k[:160], v / 1e6) for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        """The longest device-idle stretches, each named by the innermost of the
        benchmark's spans or the program's ops that the host was in at its start."""
        longest = sorted(gaps([(d.ts, d.end) for d in self.device], self.start, self.end),
                         key=lambda g: g[0] - g[1])[:n]
        host = self.spans + self.ops
        out = []
        for s, e in longest:
            inside = [h for h in host if h.ts <= s < h.end]
            name = min(inside, key=lambda h: h.dur).name if inside else "outside any span"
            out.append((f"{name[:120]} @{(s - self.start) / 1e3:.1f}ms", (e - s) / 1e6))
        return out


def read_chrome_trace(path: str, span: str = "bench.traced") -> Trace:
    """The events of an exported Chrome trace within the span named ``span``."""
    with open(path) as f:
        events = [ev for ev in json.load(f)["traceEvents"] if ev.get("ph") == "X"]
    outer = [ev for ev in events if ev.get("name") == span]
    if not outer:
        raise RuntimeError(f"the trace has no span {span!r}")
    start = float(outer[0]["ts"])
    tr = Trace(start, start + float(outer[0].get("dur", 0.0)))
    for ev in events:
        cat = ev.get("cat", "")
        tid = ev.get("tid", 0)
        e = Event(ev.get("name", ""), float(ev["ts"]), float(ev.get("dur", 0.0)),
                  tid if isinstance(tid, int) else hash(tid),
                  ev.get("args", {}).get("correlation"))
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            tr.device.append(e)
            if cat == "kernel":
                tr.kernels.append(e)
            elif cat == "gpu_memcpy":
                tr.copies.append(e)
        elif cat.startswith("cuda_"):          # the runtime and its API calls
            tr.runtime.append(e)
        elif cat == "user_annotation" and e.name.startswith("bench.") and e.name != span:
            tr.spans.append(e)
        elif cat in ("cpu_op", "user_annotation"):
            tr.ops.append(e)
    return tr


class Tracer:
    """The benchmark's spans and call records around the program's layers."""

    def __init__(self):
        self.msda_calls: List[tuple] = []
        self.wattn_calls: List[tuple] = []

    def hook_module(self, module: torch.nn.Module, name: str) -> None:
        """A span named ``name`` from the module's forward pre-hook to its hook."""
        open_spans: List = []

        def pre(mod, args):
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            open_spans.append(rf)

        def post(mod, args, out):
            if open_spans:
                open_spans.pop().__exit__(None, None, None)

        module.register_forward_pre_hook(pre)
        module.register_forward_hook(post)

    @contextlib.contextmanager
    def record_calls(self) -> Iterator[None]:
        """Record the shapes of every MSDA and window-attention call the
        program's layers make while open."""
        from ocpg_tpu_torch.models import backbone_video_swin, deformable_transformer

        msda, wattn = deformable_transformer.ms_deform_attn_cm, backbone_video_swin.window_attention

        def msda_rec(value, spatial_shapes, x_cm, y_cm, aw_cm):
            n, _, m, d = value.shape
            self.msda_calls.append((tuple(map(tuple, spatial_shapes)), n, m, d,
                                    x_cm.shape[3], x_cm.shape[4], value.element_size(),
                                    torch.is_grad_enabled() and value.requires_grad))
            return msda(value, spatial_shapes, x_cm, y_cm, aw_cm)

        def wattn_rec(q, k, v, bias, mask=None):
            self.wattn_calls.append((tuple(q.shape), q.element_size(),
                                     None if mask is None else mask.shape[0],
                                     torch.is_grad_enabled() and q.requires_grad))
            return wattn(q, k, v, bias, mask)

        deformable_transformer.ms_deform_attn_cm = msda_rec
        backbone_video_swin.window_attention = wattn_rec
        try:
            yield
        finally:
            deformable_transformer.ms_deform_attn_cm = msda
            backbone_video_swin.window_attention = wattn


def profile(fn: Callable[[], None], device="cuda") -> Trace:
    """``fn()`` under ``torch.profiler`` (host and device), synchronised at
    both ends; the trace's start and end are the profiled span's."""
    from torch.profiler import ProfilerActivity

    from benchmark import device as dev

    activities = [ProfilerActivity.CPU]
    if dev.is_cuda(device):
        activities.append(ProfilerActivity.CUDA)
    dev.synchronize(device)
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function("bench.traced"):
            fn()
            dev.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return read_chrome_trace(path)
    finally:
        os.unlink(path)
