"""BENCHMARK.json against the benchmark's contract, and every cell,
configuration and metric found by name; a cell added from new files
alone runs."""

import json
import re
import time
from pathlib import Path

import torch

import tiny
from benchmark import harness

REPO = Path(__file__).resolve().parents[2]
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024
    cells = len(SPEC["workloads"])
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24


def test_names_units_and_entries():
    for config in SPEC["configs"]:
        assert set(config) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(config["name"]) and config["reduced"] == []
        assert config["file"].startswith("benchmark/configs/")
        assert (REPO / config["file"]).exists()
    seen = set()
    for cell in SPEC["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
        assert cell["chips"] == 1 and 1 <= len(cell["why"]) <= 200
        assert (cell["config"], cell["traffic"]) not in seen
        seen.add((cell["config"], cell["traffic"]))
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for metric in metrics:
        assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
        assert metric["better"] in ("lower", "higher")
    for metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    assert [m["name"] for m in SPEC["end_to_end"]] == [
        "ocr_pages_per_s", "agent_turns_per_s", "setup_s"]


def test_every_cell_reports_setup_a_rate_and_a_layer_metric():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for cell in SPEC["workloads"]:
        name = cell["name"]
        reported = {m["name"] for m in harness.reported(SPEC["end_to_end"],
                                                        SPEC, name)}
        assert "setup_s" in reported and len(reported) >= 2
        layers = harness.reported(SPEC["per_layer"], SPEC, name)
        assert layers
        for metric in layers:
            assert metric["moves"] in reported and metric["moves"] in e2e


def test_every_file_is_found_by_name():
    root = REPO / "benchmark"
    for cell in SPEC["workloads"]:
        spec, found_root, entry, body, model = harness.cell_files(
            REPO / "BENCHMARK.json", cell["name"])
        assert found_root == root and entry is cell or entry == cell
        assert (root / "drivers" / f"{body['driver']}.py").exists()
        assert (root / "architectures"
                / f"{model['architecture']}.py").exists()
        assert callable(harness.architecture(
            root, model["architecture"]).config)
        assert set(body["limits"])
    for metric in SPEC["per_layer"]:
        assert callable(harness.metric_reader(root, metric["name"]))


def test_a_cell_added_from_new_files_alone_runs(tmp_path):
    """A new cell is a workload file and an entry: here a third OCR mix
    over the tiny model, with its own budgets, beside the tiny cells."""
    cells = {"ocr.tiny": ("tiny-vl", tiny.ocr_cell()),
             "ocr.added": ("tiny-vl", tiny.ocr_cell(
                 pages=1, budget={"median": 3, "sigma": 0.1, "min": 3,
                                  "max": 3}, close_at="folder",
                 limits={"max_logit_gap": 1.0}))}
    spec = tiny.make(tmp_path, cells)
    out = harness.run_cell(spec, "ocr.added", 31, 0.5, False,
                           torch.device("cpu"), time.perf_counter())
    assert out["correct"] and out["attempted"] >= 1
    assert set(out["metrics"]) == {"ocr_pages_per_s", "setup_s"}
    assert list(out)[-1] == "checks"
