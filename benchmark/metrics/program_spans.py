"""Arithmetic that the readers of the program's own spans share.  The
program marks its layer boundaries with ``ocpg.*`` spans
(``ocpg_tpu_torch/utils/profiling.py``), which a traced run's ``Trace``
holds among its ops; each reader picks its spans by exact name, and
every function returns None where the spans it needs are absent (a cell
of another kind, a program without them)."""

from __future__ import annotations

from typing import Iterable, List, Mapping, Optional


def named(tr, name: str) -> List:
    """The program's spans called exactly ``name``."""
    return [e for e in tr.ops if e.name == name]


def traced(ctx: Mapping, kind: str):
    """The run's ``Trace`` where the cell is of ``kind``, else None."""
    tr = ctx.get("trace")
    return tr if ctx.get("kind") == kind and tr is not None else None


def host_ms_per_step(ctx: Mapping, names: Iterable[str]) -> Optional[float]:
    """Host ms per ``ocpg.step`` inside the spans ``names``, less the time
    blocked in CUDA synchronisation inside them."""
    tr = traced(ctx, "train")
    if tr is None:
        return None
    steps = named(tr, "ocpg.step")
    spans = [e for n in names for e in named(tr, n)]
    if not steps or not spans:
        return None
    return (sum(e.dur for e in spans) - tr.sync_us_within(spans)) / len(steps) / 1e3


def device_ms_per_forward(ctx: Mapping, stages: Iterable[str]) -> Optional[float]:
    """Device ms per ``ocpg.forward`` of the operations launched inside the
    stage spans ``stages`` (by correlation id)."""
    tr = traced(ctx, "infer")
    if tr is None:
        return None
    stages = list(stages)
    forwards = named(tr, "ocpg.forward")
    if not forwards or not tr.device or not all(named(tr, s) for s in stages):
        return None
    return sum(tr.device_us_under(s) for s in stages) / len(forwards) / 1e3


def host_ms_per_request(ctx: Mapping, names: Iterable[str],
                        less: Iterable[str] = ()) -> Optional[float]:
    """Host ms per traced request inside the engine's spans ``names``, less
    the host ms inside the spans ``less``."""
    tr = traced(ctx, "infer")
    if tr is None or not ctx.get("traced_requests"):
        return None
    spans = [e for n in names for e in named(tr, n)]
    if not spans:
        return None
    host = sum(e.dur for e in spans) - sum(e.dur for n in less for e in named(tr, n))
    return host / ctx["traced_requests"] / 1e3
