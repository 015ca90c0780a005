"""Tracing and timing hooks: counterpart of ``ocpg_tpu/utils/profiling.py``.

``trace(logdir)`` records the enclosed steps with ``torch.profiler`` (the
host and, on a GPU, the device) and writes a Chrome trace, viewable in
Perfetto or ``chrome://tracing``; ``StepTimer`` splits wall time between
waiting for data and the step; ``device_memory_stats`` reads the CUDA
allocator's peak and in-use memory per device.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """Profile the enclosed code into ``<logdir>/trace.json`` (a no-op when
    logdir is None)."""
    if not logdir:
        yield
        return
    import torch
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
    import torch

    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        out[f"cuda:{i}"] = {
            "peak_gib": round(torch.cuda.max_memory_allocated(i) / 2**30, 3),
            "in_use_gib": round(torch.cuda.memory_allocated(i) / 2**30, 3),
        }
    return out
