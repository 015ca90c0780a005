"""The port's spans and counters on the CPU (``utils/profiling.py``).

With no profiler active ``span()`` is one shared no-op and the kept
record moves only for kept spans.  Under ``torch.profiler`` one
``TrainStep`` call and one engine ``run()`` of two requests export every
span of their tables in the Chrome trace, each inside its parent, also
where the engine reuses a video's backbone results; the engine's
counters equal the sums reckoned by hand; one
``build_model`` keeps one ``ocpg.init`` entry.  The model is the tiny
float32 ResNet configuration of tests/test_torch_model.py.

The backbone's backward span ``ocpg.grad.backbone`` is held on a tiny 2D
Swin train step whose window attention and MSDA run through the kernels'
autograd Functions (the plain forwards in place of the launches), so that
their backward nodes are named in the trace: one range a step, holding
every window-attention backward and no MSDA backward, and with per-block
recompute (``use_checkpoint``) every recomputed window-attention forward
too; no marker node in the graph without a profiler; a traced and an
untraced step from one state give bit-equal losses and gradients, with
recompute or without.
"""
import copy
import json

import numpy as np
import pytest
import torch

from ocpg_tpu_torch.config import OCPGConfig
from ocpg_tpu_torch.data.synthetic import synthetic_batch
from ocpg_tpu_torch.engine.infer import ClipInferenceEngine, InferRequest
from ocpg_tpu_torch.engine.optim import build_optimizer
from ocpg_tpu_torch.engine.train import TrainStep
from ocpg_tpu_torch.models import backbone_swin2d, backbone_video_swin, deformable_transformer
from ocpg_tpu_torch.models.build import build_model, build_weight_dict, criterion_config
from ocpg_tpu_torch.ops import ms_deform_attn, window_attention
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


# ------------------------------------------------ the backbone's backward --
SWIN_CFG = dict(CFG, backbone="swin_span_test", dataset_file="ytvos")
SWIN_SPAN_TEST = dict(embed_dim=32, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8))
# every span the port records, from utils/profiling.py's docstring
SPAN_NAMES = ("ocpg.step", "ocpg.step.upload", "ocpg.loss", "ocpg.backward", "ocpg.optim.clip",
              "ocpg.step.readback", "ocpg.optim.step", "ocpg.forward", "ocpg.backbone",
              "ocpg.text", "ocpg.fusion", "ocpg.transformer", "ocpg.heads", "ocpg.matcher",
              "ocpg.grad.backbone", "ocpg.engine.run", "ocpg.engine.dispatch",
              "ocpg.engine.assemble", "ocpg.engine.upload", "ocpg.engine.drain",
              "ocpg.engine.wait", "ocpg.init")
WATTN_FWD = "_WindowAttentionFunction"
WATTN_BWD, MSDA_BWD = WATTN_FWD + "Backward", "_MSDAFunctionBackward"


def _wattn_function(q, k, v, bias, mask=None):
    return window_attention._WindowAttentionFunction.apply(
        q, k, v, bias.to(q.dtype).contiguous(),
        None if mask is None else mask.to(q.dtype).contiguous())


def _msda_function(value, spatial_shapes, x_cm, y_cm, aw_cm):
    return ms_deform_attn._MSDAFunction.apply(value, x_cm, y_cm, aw_cm,
                                              tuple(map(tuple, spatial_shapes)))


@pytest.fixture(params=[False, True], ids=["plain", "recompute"])
def swin_step_parts(request, monkeypatch):
    """A tiny 2D Swin model, without and with per-block recompute, whose
    window attention and MSDA run through the kernels' autograd Functions on
    the CPU for the one test that asks for it, and a batch."""
    monkeypatch.setitem(backbone_swin2d._CONFIGS, "swin_span_test", SWIN_SPAN_TEST)
    monkeypatch.setattr(window_attention, "_launch", window_attention.window_attention_reference)
    monkeypatch.setattr(ms_deform_attn, "_launch", ms_deform_attn.ms_deform_attn_cm_reference)
    monkeypatch.setattr(backbone_video_swin, "window_attention", _wattn_function)
    monkeypatch.setattr(deformable_transformer, "ms_deform_attn_cm", _msda_function)
    model = build_model(OCPGConfig(**SWIN_CFG, use_checkpoint=request.param), device="cpu")
    assert model.backbone.use_checkpoint == request.param
    batch = synthetic_batch(np.random.default_rng(3), batch=1, frames=2, height=64,
                            width=64, text_len=8, vocab_size=1000)
    return model, batch


def _train_step(model):
    cfg = model.cfg
    return TrainStep(model, criterion_config(cfg), build_weight_dict(cfg),
                     build_optimizer(model, cfg))


def traced_events(fn, tmp_path):
    """Every complete event of ``fn()`` under the profiler: (name, tid, start, end)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [(ev["name"], ev["tid"], ev["ts"], ev["ts"] + ev["dur"])
            for ev in json.loads(path.read_text())["traceEvents"] if ev.get("ph") == "X"]


def test_backbone_backward_span_holds_the_backbone_backward(swin_step_parts, tmp_path):
    """Two traced steps: one ``ocpg.grad.backbone`` range in each step's
    backward, on the thread of the backward's nodes, holding every window
    attention's backward node and no MSDA backward node; with recompute
    also one window-attention forward a block (the recompute's), without
    recompute none."""
    model, batch = swin_step_parts
    step = _train_step(copy.deepcopy(model))
    events = traced_events(lambda: [step(batch) for _ in range(2)], tmp_path)

    def named(name):
        return [e for e in events if e[0] == name]

    ranges, steps = named("ocpg.grad.backbone"), named("ocpg.step")
    assert len(steps) == 2 and len(ranges) == 2
    for s in steps:
        assert sum(s[2] <= r[2] and r[3] <= s[3] for r in ranges) == 1

    def inside(e):
        return any(r[1] == e[1] and r[2] <= e[2] and e[3] <= r[3] for r in ranges)

    wattn, msda = named(WATTN_BWD), named(MSDA_BWD)
    assert len(wattn) == 2 * 4 and len(msda) > 0     # 4 blocks a step
    assert all(inside(e) for e in wattn)
    assert not any(inside(e) for e in msda)
    recomputed = sum(inside(e) for e in named(WATTN_FWD))
    assert recomputed == (2 * 4 if model.backbone.use_checkpoint else 0)


def _graph_names(roots):
    """The names of every node of the autograd graph behind ``roots``."""
    seen, todo = set(), [r.grad_fn for r in roots if r.grad_fn is not None]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(n for n, _ in node.next_functions)
    return {type(n).__name__ for n in seen}


def test_no_marker_node_without_a_profiler(swin_step_parts):
    model, batch = swin_step_parts
    from ocpg_tpu_torch.data.loader import decompress_batch

    def tensors(x):
        if isinstance(x, dict):
            return {k: tensors(v) for k, v in x.items()}
        return torch.as_tensor(np.asarray(x))

    b = decompress_batch(tensors(batch))

    def forward():
        out = model(b["samples"], b["samples_mask"], b["text_ids"], b["text_mask"],
                    b["targets"]["size"], targets=b["targets"], train=True)
        return [v for v in out.values() if isinstance(v, torch.Tensor) and v.requires_grad]

    plain = _graph_names(forward())
    assert WATTN_BWD in plain and not any("BackwardSpan" in n for n in plain)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = _graph_names(forward())
    assert {n for n in traced if "BackwardSpan" in n} == {"_BackwardSpanBeginBackward",
                                                          "_BackwardSpanEndBackward"}
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.backward_span("ocpg.grad.backbone", "cpu") is None


def test_traced_and_untraced_steps_are_bit_equal(swin_step_parts, tmp_path):
    model, batch = swin_step_parts
    plain, traced = _train_step(copy.deepcopy(model)), _train_step(copy.deepcopy(model))
    want = plain(batch)
    got = {}
    names = [e[0] for e in traced_events(lambda: got.update(traced(batch)), tmp_path)]
    assert "ocpg.grad.backbone" in names
    assert got == want
    for (n, p), q in zip(plain.model.named_parameters(), traced.model.parameters()):
        assert (p.grad is None) == (q.grad is None), n
        assert p.grad is None or torch.equal(p.grad, q.grad), n
        assert torch.equal(p, q), n


def test_span_names_hold_no_other():
    """A reader may match the spans by substring (``Trace.device_us_under``):
    no name holds another, but for ``ocpg.step``'s own two parts, which
    readers match exactly."""
    assert len(set(SPAN_NAMES)) == len(SPAN_NAMES)
    for a in SPAN_NAMES:
        for b in SPAN_NAMES:
            if a != b and a in b:
                assert (a, b) in {("ocpg.step", "ocpg.step.upload"),
                                  ("ocpg.step", "ocpg.step.readback")}, (a, b)
    for name in SPAN_NAMES:
        assert name in profiling.__doc__, name
