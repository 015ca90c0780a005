"""The readers of the program's own spans and counters on synthetic traces:
each reads its number from known ``ocpg.*`` spans, runtime calls and
kernels, and reads None where its spans or counters are absent (a
program without them, a cell of the other kind)."""

import pytest

from benchmark import manifest
from benchmark.trace import Event, Trace

SYNC = "cudaStreamSynchronize"
LAUNCH = "cudaLaunchKernel"


def span(name, ts, end, tid=1):
    return Event(name, ts, end - ts, tid)


def train_trace():
    """Two steps; a sync inside the first forward; launches from the main
    thread, from autograd's thread, of a graph (three kernels on one id),
    and one outside any step."""
    ops = [span("ocpg.step", 0, 100), span("ocpg.step", 100, 200),
           span("ocpg.forward", 5, 45), span("ocpg.forward", 105, 135),
           span("ocpg.loss", 45, 55), span("ocpg.loss", 135, 150),
           span("ocpg.backward", 55, 80), span("ocpg.backward", 150, 170),
           span("ocpg.optim.clip", 80, 85), span("ocpg.optim.clip", 170, 172),
           span("ocpg.optim.step", 88, 95), span("ocpg.optim.step", 180, 190),
           span("aten::mm", 6, 8)]
    runtime = [Event(SYNC, 40, 4, 1), Event(LAUNCH, 10, 1, 1, 1), Event(LAUNCH, 60, 1, 2, 2),
               Event(LAUNCH, 150, 1, 1, 3), Event(LAUNCH, 250, 1, 1, 4),
               Event("cudaGraphLaunch", 120, 1, 1, 5)]
    kernels = [Event(f"k{c}", 300 + c, 1, 9, c) for c in (1, 2, 3, 4, 5, 5, 5)]
    return Trace(0, 400, device=list(kernels), kernels=kernels, runtime=runtime, ops=ops)


def infer_trace():
    """One ``run()`` of two requests, each a dispatch (assembly, upload and
    a forward with its five stages, one launch in each) and a drain."""
    ops = [span("ocpg.engine.run", 0, 100),
           span("ocpg.engine.dispatch", 2, 30), span("ocpg.engine.dispatch", 30, 60),
           span("ocpg.engine.assemble", 3, 10), span("ocpg.engine.assemble", 31, 35),
           span("ocpg.engine.upload", 10, 12), span("ocpg.engine.upload", 35, 37),
           span("ocpg.engine.drain", 60, 80), span("ocpg.engine.drain", 80, 95),
           span("ocpg.engine.wait", 61, 70), span("ocpg.engine.wait", 81, 82)]
    runtime, kernels = [], []
    stages = ("ocpg.backbone", "ocpg.text", "ocpg.fusion", "ocpg.transformer", "ocpg.heads")
    durs = ({"ocpg.backbone": 10, "ocpg.text": 1, "ocpg.fusion": 3, "ocpg.transformer": 4,
             "ocpg.heads": 2},
            {"ocpg.backbone": 12, "ocpg.text": 1, "ocpg.fusion": 5, "ocpg.transformer": 6,
             "ocpg.heads": 2})
    for i, start in enumerate((12, 37)):
        ops.append(span("ocpg.forward", start, start + 20))
        for j, stage in enumerate(stages):
            ts = start + 4 * j
            corr = 10 * (i + 1) + j
            ops.append(span(stage, ts, ts + 4))
            runtime.append(Event(LAUNCH, ts + 1, 1, 1, corr))
            kernels.append(Event(f"k{corr}", 200 + corr, durs[i][stage], 9, corr))
    return Trace(0, 400, device=list(kernels), kernels=kernels, runtime=runtime, ops=ops)


def read(name, ctx):
    return manifest.metric_reader(name)(ctx)


TRAIN = {"fwd_host_ms.train": (40 + 30 - 4) / 2 / 1e3,
         "loss_host_ms.train": (10 + 15) / 2 / 1e3,
         "bwd_host_ms.train": (25 + 20) / 2 / 1e3,
         "optim_host_ms.train": (5 + 2 + 7 + 10) / 2 / 1e3,
         "launches_per_step.train": 6 / 2}
INFER = {"queue_wait_ms.infer": (2 + 30) / 2 / 1e3,
         "assemble_ms.infer": (7 + 4 + 2 + 2) / 2 / 1e3,
         "drain_ms.infer": (20 + 15 - 9 - 1) / 2 / 1e3,
         "backbone_device_ms.infer": (10 + 12) / 2 / 1e3,
         "fusion_device_ms.infer": (1 + 3 + 1 + 5) / 2 / 1e3,
         "transformer_device_ms.infer": (4 + 6) / 2 / 1e3,
         "head_device_ms.infer": (2 + 2) / 2 / 1e3}


@pytest.mark.parametrize("name", sorted(TRAIN) + sorted(INFER))
def test_span_readers(name):
    train = {"kind": "train", "trace": train_trace()}
    infer = {"kind": "infer", "trace": infer_trace(), "traced_requests": 2}
    ctx, other = (train, infer) if name in TRAIN else (infer, train)
    assert read(name, ctx) == pytest.approx({**TRAIN, **INFER}[name])
    # absent: a cell of the other kind, a program without the spans
    assert read(name, other) is None
    bare = dict(ctx, trace=Trace(0, 400, device=ctx["trace"].device,
                                 kernels=ctx["trace"].kernels, runtime=ctx["trace"].runtime))
    assert read(name, bare) is None
    assert read(name, {k: v for k, v in ctx.items() if k != "trace"}) is None


def test_counter_readers(monkeypatch):
    from ocpg_tpu_torch.engine import infer
    from ocpg_tpu_torch.utils import profiling

    monkeypatch.setattr(infer, "pixels_real", 69)
    monkeypatch.setattr(infer, "pixels_dispatched", 100)
    assert read("pad_share.infer", {"kind": "infer"}) == pytest.approx(31.0)
    assert read("pad_share.infer", {"kind": "train"}) is None
    monkeypatch.setattr(infer, "pixels_dispatched", 0)
    assert read("pad_share.infer", {"kind": "infer"}) is None
    monkeypatch.delattr(infer, "pixels_dispatched")
    assert read("pad_share.infer", {"kind": "infer"}) is None

    monkeypatch.setattr(profiling, "kept", [("ocpg.init", 12.5), ("ocpg.other", 1.0)])
    assert read("init_s", {}) == 12.5
    monkeypatch.setattr(profiling, "kept", [])
    assert read("init_s", {}) is None
    monkeypatch.delattr(profiling, "kept_seconds")
    assert read("init_s", {}) is None
