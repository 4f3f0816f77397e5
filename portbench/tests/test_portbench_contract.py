"""BENCHMARK.json against the rules it is written to, and every cell's
files found by name, also for a cell added as files alone."""

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TEXT_KEYS = ("why", "layer", "source")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/") and ".." not in word
        if word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # a full check of 24 cells: 2 + 14 per cell runs of run_seconds + 60 s, 180 s a cell to compile, 1200 spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and 1 <= len(BENCH["configs"]) <= 24
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, cells // 4)


def test_names_units_and_texts():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"] + metrics]
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        assert len({x["name"] for x in group}) == len(group)
    for n in names + [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in BENCH["configs"] + BENCH["workloads"] + BENCH["per_layer"]:
        for k in TEXT_KEYS:
            if k in x:
                assert 1 <= len(x[k]) <= 200 and "\n" not in x[k] and "\t" not in x[k]
    assert len({w["config"] + "/" + w["traffic"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files_and_reports_what_it_must(cell):
    f = harness.cell_files(ROOT, cell)
    assert f.driver_path.is_file() and all(p.is_file() for p in f.readers.values())
    assert f.limits and all(isinstance(v, (int, float)) for v in f.limits.values())
    e2e = {m["name"] for m in f.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and f.per_layer
    for m in f.per_layer:  # each per-layer metric moves an end-to-end metric the cell reports
        assert m["moves"] in e2e
    assert f.config_entry["file"].startswith(BENCH["paths"][0] + "/")


def test_per_layer_layers_are_spelled_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "portbench" / "traffic" / "walks-b2-fp32.json").write_text(
        json.dumps({"driver": "sample_walks", "batch": 2, "compute_dtype": "float32"}))
    (root / "portbench" / "limits" / "sample-b2-fp32.json").write_text(json.dumps({"walk_mean_gap": 1e-3}))
    bench["workloads"].append({"name": "sample-b2-fp32", "config": "sinddm-d160-balloons",
                               "traffic": "walks-b2-fp32", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("sample-b2-fp32")
    for m in bench["per_layer"]:
        if m["moves"] == "sample_images_per_s":
            m["workloads"].append("sample-b2-fp32")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    f = harness.cell_files(root, "sample-b2-fp32")
    assert f.traffic["batch"] == 2 and f.limits == {"walk_mean_gap": 1e-3}
    assert f.driver_path == root / "portbench" / "drivers" / "sample_walks.py"
    assert {m["name"] for m in f.per_layer} == {"kernel1_roofline.sample", "kernel2_roofline.sample",
                                                 "mfu.sample", "idle_share.sample"}
