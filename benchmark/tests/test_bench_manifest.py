"""BENCHMARK.json against the contract's shape, and the files it names."""

import os
import re

import pytest

from benchmark import manifest

ROOT = manifest.ROOT
M = manifest.load_manifest()
TEXT = re.compile(r"^[^\t\n]{1,200}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTH = re.compile(r"(_dim|_rank|hidden|intermediate|latent|state|proj|head|ffn|expansion)")


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= len(M["command"]) <= 32 and all(TEXT.match(w) for w in M["command"])
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p) and ".." not in p
        assert not p.endswith("_torch")
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_check_budget_fits():
    """2 + 14 x 24 cells of (run_seconds + 60) s, 2 x 90 s compile per cell,
    1200 s spare, in 43200 s."""
    cells = 24
    total = (2 + 14 * cells) * (M["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entries_keys_and_names(section):
    names = set()
    for e in M[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert ENTRY_KEYS[section] <= set(e) <= ENTRY_KEYS[section] | extra, e
        assert manifest.NAME.match(e["name"]), e["name"]
        assert e["name"] not in names
        names.add(e["name"])
        if "unit" in e:
            assert manifest.UNIT.match(e["unit"])
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and key != "source" or section == "configs" and key == "source":
                assert TEXT.match(e[key]), (key, e[key])


def test_metric_names_unique_across_sections():
    names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(names) == len(set(names))


def test_bounds():
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in M["end_to_end"])
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_configs_files_and_reduced():
    used = {w["config"] for w in M["workloads"]}
    files = set()
    for c in M["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        data = manifest.load_json(os.path.join(ROOT, c["file"]))
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and not any(WIDTH.search(k) for k in c["reduced"])
        from benchmark.reference.config import OCPGConfig

        OCPGConfig(**data["model"])         # every field is the model's


def test_workloads():
    configs = {c["name"] for c in M["configs"]}
    pairs = set()
    fours = 0
    for w in M["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert manifest.NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        fours += w["chips"] == 4
        cell = manifest.find_cell(M, w["name"])
        assert cell.traffic["work"] in ("clips", "videos")
        assert all(isinstance(v, (int, float)) and v > 0 for v in cell.limits.values())
    assert fours <= max(1, len(M["workloads"]) // 4)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in M["workloads"]:
        e2e = [m["name"] for m in M["end_to_end"] if manifest.reports(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(manifest.reports(m, w["name"]) for m in M["per_layer"])


def test_moves_names_an_end_to_end_metric_each_listed_cell_reports():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    cells = [w["name"] for w in M["workloads"]]
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert manifest.reports(e2e[m["moves"]], cell), (m["name"], cell)


def test_metric_layers_are_one_line_and_consistent():
    by_prefix = {}
    for m in M["per_layer"]:
        assert TEXT.match(m["layer"])
        by_prefix.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_prefix.values())


def test_every_metric_has_a_reader():
    for m in M["end_to_end"] + M["per_layer"]:
        assert callable(manifest.metric_reader(m["name"]))


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "benchmark")):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.fullmatch(r"[A-Za-z0-9_./\-]+", rel), rel
