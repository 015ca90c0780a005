"""The engine's reuse of a video's backbone results (``engine/infer.py``).

Within one ``run()`` a group whose rows carry the same ``frames`` objects
as the previous group's runs no backbone of its own.  Its masks, query
scores and reference points equal, to the bit, those of the same requests
each carrying a copy of its frames, where every group runs in full; the
counters say which groups ran the backbone.  Nothing is reused across two
``run()`` calls.  The model is the tiny float32 ResNet configuration of
tests/test_torch_model.py, on the DAVIS/YTVOS and the A2D branch.
"""
import numpy as np
import pytest

from ocpg_tpu_torch.config import OCPGConfig
from ocpg_tpu_torch.engine import infer
from ocpg_tpu_torch.engine.infer import ClipInferenceEngine, InferRequest
from ocpg_tpu_torch.models.build import build_model
from ocpg_tpu_torch.utils import profiling

from tests.torch_threads import one_torch_thread  # noqa: F401

CFG = dict(backbone="resnet50", enc_layers=1, dec_layers=2, dim_feedforward=64,
           num_queries=5, num_frames=2, compute_dtype="float32",
           text_layers=2, text_hidden=128, text_heads=4, text_ffn=256, text_vocab=1000,
           text_max_pos=40)
BUCKETS = ((64, 64), (64, 128))
LT = 8


@pytest.fixture(scope="module")
def models():
    return {ds: build_model(OCPGConfig(**CFG, dataset_file=ds), device="cpu").eval()
            for ds in ("ytvos", "a2d")}


def video(rng, t, h, w, wire):
    if wire == "uint8":
        return rng.integers(0, 256, (t, h, w, 3), dtype=np.uint8)
    return rng.standard_normal((t, h, w, 3)).astype(np.float32)


def expressions(rng, frames, n):
    """``n`` requests on one frames array, the last with a forced query."""
    out = []
    for i in range(n):
        ids = rng.integers(4, 999, LT).astype(np.int32)
        mask = np.ones(LT, np.int32)
        mask[LT - 1 - i % 3:] = 0
        out.append(InferRequest(frames, ids, mask, query_override=2 if i == n - 1 else -1))
    return out


def copied(requests):
    return [InferRequest(r.frames.copy(), r.text_ids, r.text_mask, r.query_override)
            for r in requests]


def served(engine, requests):
    """(masks, query scores, reference points) of one run, and the
    counters' (runs, reused) over it, which the backbone's calls match."""
    profiling.reset_counts(profiling.ENGINE_COUNTERS)
    calls = []
    hook = engine.model.backbone.register_forward_hook(lambda *_: calls.append(1))
    try:
        masks = engine.run(requests)
    finally:
        hook.remove()
    counts = (infer.backbone_runs, infer.backbone_reused)
    assert len(calls) == counts[0]
    return (masks, list(engine.last_query_scores), list(engine.last_ref_points)), counts


def assert_same(got, want):
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)


def engine_for(models, dataset, slots):
    davis = dataset == "ytvos"
    return ClipInferenceEngine(models[dataset], clip_len=2, buckets=BUCKETS, slots=slots,
                               want_query_scores=davis, want_ref_points=davis, device="cpu")


@pytest.mark.parametrize("slots", [1, 2])
@pytest.mark.parametrize("wire", ["uint8", "float32"])
@pytest.mark.parametrize("dataset", ["ytvos", "a2d"])
def test_shared_frames_serve_what_copies_serve(models, dataset, wire, slots):
    rng = np.random.default_rng(7)
    requests = expressions(rng, video(rng, 2, 48, 64, wire), 4)
    engine = engine_for(models, dataset, slots)
    shared, counts = served(engine, requests)
    full, full_counts = served(engine, copied(requests))
    assert_same(shared, full)
    assert [m.shape for m in shared[0]] == [(2, 48, 64)] * 4
    groups = 4 // slots
    assert counts == (1, groups - 1)
    assert full_counts == (groups, 0)


def test_no_reuse_across_runs(models):
    rng = np.random.default_rng(8)
    frames = video(rng, 2, 40, 100, "uint8")
    requests = expressions(rng, frames, 3)
    engine = engine_for(models, "ytvos", 1)
    _, first = served(engine, requests)
    frames[:] = video(rng, 2, 40, 100, "uint8")      # the caller refills its buffer
    again, second = served(engine, requests)
    want, _ = served(engine_for(models, "ytvos", 1), copied(requests))
    assert_same(again, want)
    assert first == second == (1, 2)


def test_only_consecutive_groups_reuse(models):
    rng = np.random.default_rng(9)
    a, b = video(rng, 2, 48, 64, "uint8"), video(rng, 1, 64, 100, "uint8")
    c = video(rng, 2, 48, 64, "uint8")
    ra, rb, rc = (expressions(rng, f, 3) for f in (a, b, c))
    # A and C share the 64x64 canvas, B takes 64x128: the groups run per
    # canvas, A A C A then B B
    requests = [ra[0], rb[0], ra[1], rc[0], rb[1], ra[2]]
    engine = engine_for(models, "ytvos", 1)
    shared, counts = served(engine, requests)
    full, _ = served(engine, copied(requests))
    assert_same(shared, full)
    assert counts == (4, 2)
    assert engine.last_canvas == [(64, 64), (64, 128), (64, 64), (64, 64), (64, 128), (64, 64)]
