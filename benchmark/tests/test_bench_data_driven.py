"""A configuration, a traffic mix, a per-layer metric and a cell are added as
new files and manifest entries: the harness finds them by name, and no file
that is there is edited."""

import json
import os
import shutil

from benchmark import manifest


def test_new_files_are_found_by_name(tmp_path):
    base = tmp_path / "benchmark"
    shutil.copytree(manifest.HERE, base, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    m = manifest.load_manifest()

    # a new configuration, mix, metric and cell: files and entries only
    cfg = json.loads((base / "configs" / "ocpg_r101_ytvos.json").read_text())
    cfg["name"] = "ocpg_r50_new"
    cfg["model"]["backbone"] = "resnet50"
    (base / "configs" / "ocpg_r50_new.json").write_text(json.dumps(cfg))
    mix = json.loads((base / "traffic" / "train_clips_b8.json").read_text())
    mix["batch"] = 1
    (base / "traffic" / "train_clips_b1.json").write_text(json.dumps(mix))
    (base / "limits" / "r50_train_b1.json").write_text(json.dumps({"loss_gap": 0.5}))
    (base / "metrics" / "steps_new.train.py").write_text(
        "def read(ctx):\n    return ctx.get('steps')\n")
    m["configs"].append({"name": "ocpg_r50_new", "source": "x",
                         "file": "benchmark/configs/ocpg_r50_new.json", "reduced": [],
                         "why": "x"})
    m["workloads"].append({"name": "r50_train_b1", "config": "ocpg_r50_new",
                           "traffic": "train_clips_b1", "chips": 1, "why": "x"})
    m["per_layer"].append({"name": "steps_new.train", "unit": "steps", "better": "higher",
                           "source": "program_counter", "layer": "x",
                           "moves": "train_clips_per_s", "workloads": ["r50_train_b1"]})
    for e in m["end_to_end"]:
        if e["name"] == "train_clips_per_s":
            e["workloads"].append("r50_train_b1")

    cell = manifest.find_cell(m, "r50_train_b1", str(base))
    assert cell.config["model"]["backbone"] == "resnet50"
    assert cell.traffic["batch"] == 1 and cell.limits == {"loss_gap": 0.5}
    assert [x["name"] for x in cell.per_layer] == ["steps_new.train"]
    assert "train_clips_per_s" in [x["name"] for x in cell.end_to_end]
    read = manifest.read_metrics(cell.per_layer, {"steps": 7}, str(base))
    assert read == {"steps_new.train": {"value": 7.0, "unit": "steps"}}
    assert manifest.work_module(cell.traffic["work"], str(base)).run
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


def test_a_reader_that_finds_nothing_is_left_out():
    metrics = [{"name": "msda_roofline.train", "unit": "%"},
               {"name": "train_clips_per_s", "unit": "clips/s"}]
    ctx = {"kind": "train", "clips": 80, "window_s": 10.0}
    assert manifest.read_metrics(metrics, ctx) == {
        "train_clips_per_s": {"value": 8.0, "unit": "clips/s"}}


def test_cells_find_their_files():
    m = manifest.load_manifest()
    for w in m["workloads"]:
        cell = manifest.find_cell(m, w["name"])
        assert os.path.exists(os.path.join(manifest.HERE, "kinds",
                                           cell.traffic["work"] + ".py"))
