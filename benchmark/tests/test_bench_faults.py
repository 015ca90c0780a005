"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have; the sound run comes out correct.  The run
skips the look for a card and drives everything else on the CPU, at a tiny
size, with the program in float32 (its round-off is then far under the
test limits in ``data/limits``)."""

import numpy as np
import pytest

from benchmark.tests.test_bench_reference import drive


def test_sound_runs_are_correct():
    assert drive("f32_train")["correct"]
    assert drive("f32_infer")["correct"]


def test_a_step_that_leaves_its_state_unchanged(monkeypatch):
    from ocpg_tpu_torch.engine.optim import TrainOptimizer

    monkeypatch.setattr(TrainOptimizer, "step", lambda self: None)
    out = drive("f32_train")
    assert not out["correct"] and out["checks"]["change_gap"]["value"] >= 0.99


def test_half_of_the_batch_left_out(monkeypatch):
    from ocpg_tpu_torch.engine.train import TrainStep

    call = TrainStep.__call__

    def halved(self, batch):
        def cut(x):
            return {k: cut(v) for k, v in x.items()} if isinstance(x, dict) else x[: len(x) // 2]
        return call(self, cut(batch))

    monkeypatch.setattr(TrainStep, "__call__", halved)
    assert not drive("f32_train")["correct"]


@pytest.mark.parametrize("how", ["next_request", "negated_frame"])
def test_an_answer_altered_where_it_is_produced(monkeypatch, how):
    from ocpg_tpu_torch.engine.infer import ClipInferenceEngine

    run = ClipInferenceEngine.run

    def altered(self, requests, progress=None):
        out = run(self, requests, progress)
        if how == "next_request" and len(out) > 1:
            return out[1:] + out[:1]
        out = [np.array(m) for m in out]
        out[-1][0] = -out[-1][0]
        return out

    monkeypatch.setattr(ClipInferenceEngine, "run", altered)
    assert not drive("f32_infer")["correct"]


def test_one_layers_matcher_wrong(monkeypatch):
    """One decoder layer's matcher hands back another query for every
    clip: ``loss_gap`` leaves that layer's terms out, ``matcher_flips`` counts
    the slots."""
    from benchmark import manifest
    from benchmark.tests.conftest import DATA
    from ocpg_tpu_torch.models import ocpg

    cell = manifest.find_cell(manifest.load_json(DATA + "/BENCHMARK.json"), "f32_train", DATA)
    layers = cell.config["model"]["dec_layers"]
    match, calls = ocpg.match, [0]

    def wrong(cfg, pred_logits, *args):
        q = match(cfg, pred_logits, *args)
        calls[0] += 1
        return (q + 1) % pred_logits.shape[2] if calls[0] % layers == 1 % layers else q

    monkeypatch.setattr(ocpg, "match", wrong)
    out = drive("f32_train")
    assert not out["correct"] and out["checks"]["matcher_flips"]["value"] >= 2, out["checks"]
    assert out["checks"]["loss_gap"]["value"] <= out["checks"]["loss_gap"]["limit"]


def test_the_wrong_query_served(monkeypatch):
    """The eval forward picks the worst-scored query (argmin for argmax): each
    served mask is a query's own, so ``mask_gap`` passes and ``score_gap``
    catches it."""
    import torch

    from ocpg_tpu_torch.models import ocpg

    class Flipped:
        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def sigmoid(x):
            return 1.0 - torch.sigmoid(x)

    monkeypatch.setattr(ocpg, "torch", Flipped())
    out = drive("f32_infer")
    assert not out["correct"], out["checks"]
    assert out["checks"]["mask_gap"]["value"] <= out["checks"]["mask_gap"]["limit"]
    assert out["checks"]["score_gap"]["value"] > out["checks"]["score_gap"]["limit"]


def test_a_loss_altered_where_it_is_produced(monkeypatch):
    """Every loss term 5% off where the criterion produces it (the total and
    the gradients follow)."""
    from ocpg_tpu_torch.engine import train

    criterion = train.compute_criterion

    def off(*args, **kwargs):
        total, losses = criterion(*args, **kwargs)
        return total * 1.05, {k: v * 1.05 for k, v in losses.items()}

    monkeypatch.setattr(train, "compute_criterion", off)
    out = drive("f32_train")
    assert not out["correct"] and out["checks"]["loss_gap"]["value"] > 0.04


def test_one_layers_loss_terms_altered(monkeypatch):
    """The first decoder layer's loss terms 5% off where the criterion
    produces them, its matcher untouched: the other layers agree, and that
    layer's median term reads the fault."""
    from ocpg_tpu_torch.engine import train

    criterion = train.compute_criterion

    def off(*args, **kwargs):
        total, losses = criterion(*args, **kwargs)
        return total, {k: v * 1.05 if k.endswith("_0") else v for k, v in losses.items()}

    monkeypatch.setattr(train, "compute_criterion", off)
    out = drive("f32_train")
    assert not out["correct"] and out["checks"]["loss_gap"]["value"] > 0.04, out["checks"]
