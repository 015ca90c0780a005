"""The reader of the engine's backbone counters: the reused dispatches'
share of all, and None in a cell of the other kind, before any dispatch,
or in a program without the counters."""

import pytest

from benchmark import manifest


def read(ctx):
    return manifest.metric_reader("backbone_reuse_share.infer")(ctx)


def test_backbone_reuse_share(monkeypatch):
    from ocpg_tpu_torch.engine import infer

    monkeypatch.setattr(infer, "backbone_runs", 24)
    monkeypatch.setattr(infer, "backbone_reused", 72)
    assert read({"kind": "infer"}) == pytest.approx(75.0)
    assert read({"kind": "train"}) is None
    monkeypatch.setattr(infer, "backbone_reused", 0)
    assert read({"kind": "infer"}) == 0.0
    monkeypatch.setattr(infer, "backbone_runs", 0)
    assert read({"kind": "infer"}) is None
    monkeypatch.delattr(infer, "backbone_reused")
    assert read({"kind": "infer"}) is None
