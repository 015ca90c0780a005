"""The port's spans and counters on the CPU (``utils/profiling.py``).

With no profiler active ``span()`` is one shared no-op and the kept
record moves only for kept spans.  Under ``torch.profiler`` one
``TrainStep`` call and one engine ``run()`` of two requests export every
span of their tables in the Chrome trace, each inside its parent, also
where the engine reuses a video's backbone results; the engine's
counters equal the sums reckoned by hand; one
``build_model`` keeps one ``ocpg.init`` entry.  The model is the tiny
float32 ResNet configuration of tests/test_torch_model.py.
"""
import json

import numpy as np
import pytest
import torch

from ocpg_tpu_torch.config import OCPGConfig
from ocpg_tpu_torch.data.synthetic import synthetic_batch
from ocpg_tpu_torch.engine.infer import ClipInferenceEngine, InferRequest
from ocpg_tpu_torch.engine.optim import build_optimizer
from ocpg_tpu_torch.engine.train import TrainStep
from ocpg_tpu_torch.models.build import build_model, build_weight_dict, criterion_config
from ocpg_tpu_torch.utils import profiling

from tests.torch_threads import one_torch_thread  # noqa: F401

CFG = dict(backbone="resnet50", enc_layers=1, dec_layers=2, dim_feedforward=64,
           num_queries=5, num_frames=2, compute_dtype="float32", dataset_file="davis",
           text_layers=2, text_hidden=128, text_heads=4, text_ffn=256, text_vocab=1000,
           text_max_pos=40)
STAGES = ("ocpg.backbone", "ocpg.text", "ocpg.fusion", "ocpg.transformer", "ocpg.heads")
# span -> the span it lies in
TRAIN_SPANS = {"ocpg.step.upload": "ocpg.step", "ocpg.forward": "ocpg.step",
               "ocpg.loss": "ocpg.step", "ocpg.backward": "ocpg.step",
               "ocpg.optim.clip": "ocpg.step", "ocpg.step.readback": "ocpg.step",
               "ocpg.optim.step": "ocpg.step", "ocpg.matcher": "ocpg.heads",
               **{s: "ocpg.forward" for s in STAGES}}
ENGINE_SPANS = {"ocpg.engine.dispatch": "ocpg.engine.run",
                "ocpg.engine.assemble": "ocpg.engine.dispatch",
                "ocpg.engine.upload": "ocpg.engine.dispatch",
                "ocpg.forward": "ocpg.engine.dispatch",
                "ocpg.engine.drain": "ocpg.engine.run",
                "ocpg.engine.wait": "ocpg.engine.drain",
                **{s: "ocpg.forward" for s in STAGES}}


@pytest.fixture(scope="module")
def built():
    """The tiny model, and the kept record's length before and after its build."""
    before = len(profiling.kept)
    model = build_model(OCPGConfig(**CFG), device="cpu")
    return model, before, len(profiling.kept)


def traced_spans(fn, tmp_path):
    """The ``ocpg.*`` spans of ``fn()`` under the profiler, read back from
    its exported Chrome trace: name -> [(start, end)]."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = {}
    for ev in json.loads(path.read_text())["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("cat") == "user_annotation" \
                and ev["name"].startswith("ocpg."):
            spans.setdefault(ev["name"], []).append((ev["ts"], ev["ts"] + ev["dur"]))
    return spans


def assert_nested(spans, table):
    for name, parent in table.items():
        assert name in spans, (name, sorted(spans))
        for s, e in spans[name]:
            assert any(ps <= s and e <= pe for ps, pe in spans[parent]), (name, parent)


def test_span_is_a_shared_no_op_without_a_profiler():
    before = list(profiling.kept)
    a, b = profiling.span("ocpg.a"), profiling.span("ocpg.b")
    assert a is b
    with a, b:
        pass
    assert profiling.kept == before
    with profiling.span("ocpg.kept_test", keep=True):
        pass
    assert profiling.kept[:-1] == before and profiling.kept[-1][0] == "ocpg.kept_test"
    assert profiling.kept_seconds("ocpg.kept_test") >= 0.0
    assert profiling.kept_seconds("ocpg.never") is None
    del profiling.kept[len(before):]


def test_build_model_keeps_one_init_entry(built):
    _, before, after = built
    assert after == before + 1
    name, seconds = profiling.kept[before]
    assert name == "ocpg.init" and seconds > 0


def test_train_step_spans(built, tmp_path):
    model = built[0]
    cfg = model.cfg
    step = TrainStep(model, criterion_config(cfg), build_weight_dict(cfg),
                     build_optimizer(model, cfg))
    batch = synthetic_batch(np.random.default_rng(0), batch=1, frames=2, height=64, width=64,
                            text_len=8, vocab_size=1000)
    out = {}
    spans = traced_spans(lambda: out.update(step(batch)), tmp_path)
    assert out["finite"] == 1.0
    assert len(spans["ocpg.step"]) == 1
    assert_nested(spans, TRAIN_SPANS)
    assert not any(n.startswith("ocpg.engine") for n in spans)


def test_engine_spans_and_pixel_counters(built, tmp_path):
    model = built[0].eval()
    engine = ClipInferenceEngine(model, clip_len=3, buckets=((64, 64), (64, 128)), device="cpu")
    rng = np.random.default_rng(1)
    sizes = ((2, 48, 64), (3, 64, 96))      # (t, h, w): canvases 64x64 and 64x128
    reqs = [InferRequest(rng.integers(0, 256, (t, h, w, 3), dtype=np.uint8),
                         np.arange(8, dtype=np.int32), np.ones(8, np.int32))
            for t, h, w in sizes]
    profiling.reset_counts(profiling.ENGINE_COUNTERS)
    res = []
    spans = traced_spans(lambda: res.extend(engine.run(reqs)), tmp_path)
    assert [r.shape for r in res] == list(sizes)
    assert len(spans["ocpg.engine.run"]) == 1
    assert len(spans["ocpg.engine.dispatch"]) == len(spans["ocpg.engine.drain"]) == 2
    assert_nested(spans, ENGINE_SPANS)
    assert "ocpg.matcher" not in spans
    assert profiling.read_counts(profiling.ENGINE_COUNTERS) == {
        "pixels_real": 2 * 48 * 64 + 3 * 64 * 96,
        "pixels_dispatched": 3 * 64 * 64 + 3 * 64 * 128,
        "backbone_runs": 2, "backbone_reused": 0}


def test_engine_spans_when_a_video_reuses_its_backbone(built, tmp_path):
    """Three expressions of one video: the two that reuse the first's
    backbone results still open every stage span inside their forward."""
    model = built[0].eval()
    engine = ClipInferenceEngine(model, clip_len=2, buckets=((64, 64),), device="cpu")
    frames = np.random.default_rng(2).integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    reqs = [InferRequest(frames, np.arange(8, dtype=np.int32) + i, np.ones(8, np.int32))
            for i in range(3)]
    profiling.reset_counts(profiling.ENGINE_COUNTERS)
    spans = traced_spans(lambda: engine.run(reqs), tmp_path)
    assert_nested(spans, ENGINE_SPANS)
    assert all(len(spans[s]) == 3 for s in ("ocpg.forward", "ocpg.engine.assemble") + STAGES)
    counts = profiling.read_counts(profiling.ENGINE_COUNTERS)
    assert (counts["backbone_runs"], counts["backbone_reused"]) == (1, 2)
