"""The port's data and checkpoint tools (``ocpg_tpu_torch.cli.tools``)
against the JAX package's.

* ``refexp2coco`` on the REFER tree of tests/torch_data_fixtures.py and
  ``davis2ytvos`` on a small Ref-DAVIS17 release write what the JAX tools
  write, file for file and byte for byte.
* ``convert_checkpoint`` on a replica ``.pth`` at the TINY_CFG widths
  writes a port checkpoint whose ``load_params`` equals
  ``load_pretrained_torch`` of the ``.pth``; a model the checkpoint does not
  fill raises instead of saving seeded weights.
"""
import json

import numpy as np
import pytest
import torch
from PIL import Image

from ocpg_tpu.cli import tools as jax_tools

from ocpg_tpu_torch.cli import tools
from ocpg_tpu_torch.config import OCPGConfig, apply_config_overrides
from ocpg_tpu_torch.engine.checkpoint import load_params, load_pretrained_torch
from ocpg_tpu_torch.models.build import build_model

from tests import torch_data_fixtures as fx
from tests.test_e2e_evaluate import TINY_CFG
from tests.test_torch_pretrained import save_replica_pth
from tests.torch_threads import one_torch_thread  # noqa: F401


def _files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def write_davis_release(root):
    """A Ref-DAVIS17 release: 480p JPEGs and PNGs of three videos, the 2017
    image sets, the train split's expressions (valid has none)."""
    rng = np.random.default_rng(4)
    sets = {"train": ["bear", "boat"], "val": ["cows"]}
    for videos in sets.values():
        for v in videos:
            for sub in ("JPEGImages", "Annotations"):
                (root / sub / "480p" / v).mkdir(parents=True)
            for f in range(2):
                Image.fromarray((rng.random((12, 16, 3)) * 255).astype(np.uint8)).save(
                    root / "JPEGImages" / "480p" / v / f"{f:05d}.jpg")
                Image.fromarray((rng.random((12, 16)) > 0.5).astype(np.uint8)).save(
                    root / "Annotations" / "480p" / v / f"{f:05d}.png")
    (root / "ImageSets" / "2017").mkdir(parents=True)
    for name, videos in sets.items():
        (root / "ImageSets" / "2017" / f"{name}.txt").write_text("\n".join(videos) + "\n")
    (root / "meta_expressions" / "train").mkdir(parents=True)
    meta = {"videos": {v: {"frames": ["00000", "00001"],
                           "expressions": {"0": {"exp": f"the {v}", "obj_id": "1"}}}
                       for v in sets["train"]}}
    (root / "meta_expressions" / "train" / "meta_expressions.json").write_text(json.dumps(meta))
    return root


@pytest.mark.parametrize("tool", ["refexp2coco", "davis2ytvos"])
def test_data_tools_write_what_jax_writes(tool, tmp_path, capsys):
    if tool == "refexp2coco":
        src = fx.write_refer_tree(tmp_path / "refer")
        argv = ["refexp2coco", "--refer_root", str(src), "--dataset", "refcoco"]
    else:
        src = write_davis_release(tmp_path / "davis")
        argv = ["davis2ytvos", "--davis_root", str(src)]
    tools.main(argv + ["--output", str(tmp_path / "port")])
    port_out = capsys.readouterr().out
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("sys.argv", ["tools"] + argv + ["--output", str(tmp_path / "jax")])
        jax_tools.main()
    assert capsys.readouterr().out == port_out.replace(str(tmp_path / "port"),
                                                       str(tmp_path / "jax"))
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert got == want and len(got) >= 3
    if tool == "refexp2coco":
        train = json.loads(got["instances_refcoco_train.json"])
        assert [im["caption"] for im in train["images"]] == ["the red dog", "left animal"]


def _tiny_cfg():
    return apply_config_overrides(OCPGConfig(backbone="resnet50", enc_layers=1, dec_layers=2,
                                             text_layers=2), json.dumps(TINY_CFG))


def test_convert_checkpoint_then_load_params(tmp_path):
    sd = save_replica_pth(tmp_path / "ref.pth")
    tools.main(["convert_checkpoint", "--source", str(tmp_path / "ref.pth"),
                "--output", str(tmp_path / "ckpt"), "--backbone", "resnet50",
                "--enc_layers", "1", "--dec_layers", "2", "--text_layers", "2",
                "--config_overrides", json.dumps(TINY_CFG), "--device", "cpu"])
    cfg = _tiny_cfg()
    from_dir = load_params(str(tmp_path / "ckpt"), build_model(cfg, device="cpu"))
    from_pth = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(7))
    load_pretrained_torch(from_pth, str(tmp_path / "ref.pth"), cfg, drop_class_heads=False)
    a, b = from_dir.state_dict(), from_pth.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # the checkpoint's values, not the model's init
    assert torch.equal(a["query_embed"], sd["query_embed.weight"])
    assert torch.equal(a["backbone.bn1.running_var"], sd["backbone.0.body.bn1.running_var"])


def test_convert_checkpoint_refuses_a_model_it_does_not_fill(tmp_path):
    save_replica_pth(tmp_path / "ref.pth")
    wider = dict(TINY_CFG, dim_feedforward=96)
    with pytest.raises(ValueError, match="not in the checkpoint"):
        tools.convert_checkpoint(str(tmp_path / "ref.pth"), str(tmp_path / "ckpt"),
                                 "resnet50", 1, 2, 4, 2, json.dumps(wider), "cpu")
    assert not (tmp_path / "ckpt").exists() or not any((tmp_path / "ckpt").iterdir())
