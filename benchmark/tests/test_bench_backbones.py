"""The reference's backbones, found by name: every backbone the program
builds, a backbone module added as a new file, and the weights and
parameter groups of the 2D Swin."""

import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from benchmark import manifest, weights
from benchmark.reference.ocpg import OCPG, backbone_table, build_backbone
from benchmark.reference.step import config_of, group_label


def _fields(backbone):
    cfg = manifest.load_json(os.path.join(manifest.HERE, "configs", "ocpg_vswinb_ytvos.json"))
    return {**cfg["model"], "backbone": backbone}


def _program_backbones():
    """The names the program's ``models/ocpg.py::build_backbone`` takes."""
    from ocpg_tpu_torch.models import backbone_swin2d, backbone_video_swin

    return ({"resnet50", "resnet101"} | set(backbone_video_swin._CONFIGS)
            | set(backbone_swin2d._CONFIGS))


def test_the_reference_builds_every_backbone_the_program_builds():
    assert _program_backbones() <= set(backbone_table())


@pytest.mark.parametrize("backbone", ["resnet101", "video_swin_b_p4w7", "swin_t_p4w7",
                                      "swin_l_p4w7"])
def test_the_reference_model_is_the_programs(backbone):
    """At full width on the meta device: the same state_dict names, shapes and
    order, so both sides take the same drawn tensors by name, and the same
    parameter groups as the program's optimizer."""
    from ocpg_tpu_torch.config import OCPGConfig
    from ocpg_tpu_torch.engine.optim import param_group_label
    from ocpg_tpu_torch.models.ocpg import OCPG as ProgramOCPG

    fields = _fields(backbone)
    with torch.device("meta"):
        ref = OCPG(config_of(fields))
        prog = ProgramOCPG(OCPGConfig(**fields))
    shapes = [(k, tuple(v.shape)) for k, v in ref.state_dict().items()]
    assert shapes == [(k, tuple(v.shape)) for k, v in prog.state_dict().items()]
    labels = {n: group_label(ref.cfg, n) for n, _ in ref.named_parameters()}
    assert labels == {n: param_group_label(prog.cfg, n) for n, _ in prog.named_parameters()}
    assert {labels[n] for n in labels if n.startswith("backbone.")} == (
        {"backbone", "frozen"} if backbone.startswith("resnet") else {"backbone"})


def test_every_leaf_of_swin_l_has_a_weight_rule():
    """Swin-L at its published widths (embed 192, depths 2-2-18-2, heads
    6-48) in the Video Swin-B recipe: every floating state_dict entry has a
    rule, and the model is about 347 M parameters, 195 M of them the backbone's."""
    with torch.device("meta"):
        model = OCPG(config_of(_fields("swin_l_p4w7")))
    rules = weights._rules(model)
    floating = [k for k, v in model.state_dict().items() if v.is_floating_point()]
    assert floating and [k for k in floating if k not in rules] == []
    assert rules["backbone.stage2_block17.attn.relative_position_bias_table"] == (
        "clipped", 0.02, 0.04)
    assert model.backbone.num_channels == (192, 384, 768, 1536)
    assert 347e6 < sum(p.numel() for p in model.parameters()) < 347.5e6
    assert 194.9e6 < sum(p.numel() for p in model.backbone.parameters()) < 195.1e6


def test_an_unknown_backbone_names_those_on_offer():
    with pytest.raises(NotImplementedError, match="swin_l_p4w7"):
        build_backbone(config_of({"backbone": "swin_xl_p4w12"}))


NEW_BACKBONE = textwrap.dedent('''\
    """A backbone added as a new file."""

    from .backbone_video_swin import VideoSwin


    def _build(cfg):
        return VideoSwin(embed_dim=32, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8),
                         window_size=(1, 7, 7), num_frames=1)


    BACKBONES = {"swin_new_test": _build}
    ''')

CHECK_NEW = textwrap.dedent('''\
    import sys
    import torch
    from benchmark.reference.config import OCPGConfig
    from benchmark.reference.ocpg import OCPG, backbone_table
    assert "swin_new_test" in backbone_table() and "swin_l_p4w7" in backbone_table()
    cfg = OCPGConfig(backbone="swin_new_test")
    with torch.device("meta"):
        assert OCPG(cfg).backbone.num_channels == (32, 64, 128, 256)
    feats = backbone_table()["swin_new_test"](cfg)(torch.zeros(2, 3, 64, 64), num_frames=2)
    assert [tuple(f.shape) for f in feats] == [(2, 32, 16, 16), (2, 64, 8, 8),
                                               (2, 128, 4, 4), (2, 256, 2, 2)]
    bad = {m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "flax", "ocpg_tpu",
                                                   "ocpg_tpu_torch"}
    assert not bad, bad
    print("found")
    ''')


def test_a_backbone_added_as_a_new_file_is_found(tmp_path):
    """A copy of the benchmark with one new ``backbone_*.py`` beside the
    reference's modules: the lookup finds and builds it, and no file that was
    there is edited."""
    base = tmp_path / "benchmark"
    shutil.copytree(manifest.HERE, base, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    (base / "reference" / "backbone_new_test.py").write_text(NEW_BACKBONE)
    out = subprocess.run([sys.executable, "-c", CHECK_NEW], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(tmp_path), "USE_FLAX": "0"})
    assert out.returncode == 0 and out.stdout.split() == ["found"], out.stderr[-3000:]
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
