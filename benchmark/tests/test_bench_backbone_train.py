"""The train step's backbone reader on a synthetic trace, and the Swin-L
cell's files and configuration."""

import pytest
import torch

from benchmark import manifest
from benchmark.reference.ocpg import OCPG
from benchmark.reference.step import config_of
from benchmark.trace import Event, Trace

LAUNCH = "cudaLaunchKernel"


def span(name, ts, end, tid):
    return Event(name, ts, end - ts, tid)


def train_trace(with_forward=True, with_backward=True):
    """Two steps.  The forward's ``ocpg.backbone`` spans lie on the main
    thread (1), the backward's ``ocpg.grad.backbone`` spans on autograd's
    (2); each launch names its kernel by correlation id.  Launches of the
    other thread inside a span's time, and launches outside the spans, do
    not count."""
    ops = [span("ocpg.step", 0, 100, 1), span("ocpg.step", 100, 200, 1),
           span("ocpg.forward", 5, 40, 1), span("ocpg.forward", 105, 140, 1),
           span("ocpg.backward", 50, 90, 1), span("ocpg.backward", 150, 190, 1)]
    if with_forward:
        ops += [span("ocpg.backbone", 6, 20, 1), span("ocpg.backbone", 106, 120, 1)]
    if with_backward:
        ops += [span("ocpg.grad.backbone", 60, 80, 2), span("ocpg.grad.backbone", 160, 180, 2)]
    launches = [(10, 1, 1), (15, 1, 2),          # step 1 forward: kernels of 3 and 4 us
                (12, 2, 3),                      # another thread in the forward's time
                (30, 1, 4),                      # the forward after the backbone
                (65, 2, 5), (70, 2, 6),          # step 1 backward: 10 and 20 us
                (66, 1, 7),                      # the main thread in the backward's time
                (85, 2, 8),                      # the backward after the backbone
                (110, 1, 9),                     # step 2 forward: 5 us
                (170, 2, 10)]                    # step 2 backward: 30 us
    runtime = [Event(LAUNCH, ts, 1, tid, corr) for ts, tid, corr in launches]
    durs = {1: 3, 2: 4, 3: 100, 4: 100, 5: 10, 6: 20, 7: 100, 8: 100, 9: 5, 10: 30}
    kernels = [Event(f"k{c}", 300 + c, d, 9, c) for c, d in durs.items()]
    return Trace(0, 400, device=list(kernels), kernels=kernels, runtime=runtime, ops=ops)


def read(ctx):
    return manifest.metric_reader("backbone_device_ms.train")(ctx)


def test_backbone_device_ms_train_reads_both_spans_by_thread():
    ctx = {"kind": "train", "trace": train_trace()}
    assert read(ctx) == pytest.approx((3 + 4 + 10 + 20 + 5 + 30) / 2 / 1e3)


@pytest.mark.parametrize("ctx", [
    {"kind": "train", "trace": train_trace(with_backward=False)},   # a program without it
    {"kind": "train", "trace": train_trace(with_forward=False)},
    {"kind": "train", "trace": Trace(0, 400)},
    {"kind": "infer", "trace": train_trace()},                      # a serving cell
    {"kind": "train"},                                              # an untraced run
])
def test_backbone_device_ms_train_reads_none_without_its_spans(ctx):
    assert read(ctx) is None


def test_the_swin_l_cell_finds_its_files():
    cell = manifest.find_cell(manifest.load_manifest(), "swinl_train_b8")
    assert cell.config["name"] == "ocpg_swinl_ytvos" and cell.traffic["work"] == "clips"
    # no matcher_flips: no control or fault reading lies three times above
    # its sound readings in this cell
    assert set(cell.limits) == {"loss_gap", "change_gap"}
    per_layer = {m["name"] for m in cell.per_layer}
    assert {"backbone_device_ms.train", "mfu.train"} <= per_layer
    # under per-block recompute the call recorder sees each window-attention
    # call twice, both taking a gradient, so K7's roofline is not read here
    assert "wattn_roofline.train" not in per_layer
    assert {m["name"] for m in cell.end_to_end} == {"train_clips_per_s", "setup_s"}


def test_the_swin_l_configuration_builds_the_reference():
    """At its published widths and full depth on the meta device."""
    cell = manifest.find_cell(manifest.load_manifest(), "swinl_train_b8")
    cfg = cell.config
    assert cfg["reduced"] == [] and cfg["model"]["backbone"] == "swin_l_p4w7"
    with torch.device("meta"):
        model = OCPG(config_of(cfg["model"]))
    bb = model.backbone
    assert bb.use_checkpoint
    assert bb.embed_dim == 192 and bb.depths == (2, 2, 18, 2)
    assert [getattr(bb, f"stage{s}_block0").attn.num_heads for s in range(4)] == [6, 12, 24, 48]
    total = sum(p.numel() for p in model.parameters())
    assert round(total / 1e6, 1) == cfg["parameters_m"]
    assert 194.9e6 < sum(p.numel() for p in bb.parameters()) < 195.1e6
