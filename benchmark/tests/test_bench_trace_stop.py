"""Where a traced run stops its trace: at the first decode or step unit
that starts once ``--seconds`` have passed, never at a prefill. The
batcher adds an admission's ``prefill_s`` once all of its prefill calls
have run, so a trace stopped between them would count prompts whose time
the frozen counter lacks, and ``prefill_ms_per_ktok`` would read low."""

import time

import pytest
import torch

import tiny
import tiny_agents
from benchmark import harness
from benchmark.drivers import agents, ocr
from benchmark.drivers.common import PREFILLS, Window, WindowClosed

CPU = torch.device("cpu")
SEED = 2**31 + 7


def test_a_due_window_waits_past_prefills_for_its_hook():
    seen: list = []
    window = Window(0.0, "round", on_due=lambda: seen.append(True))
    window.open()
    window.at_unit(prefill=True)
    window.at_unit(prefill=True)
    assert seen == []
    window.at_unit()
    window.at_unit()
    assert seen == [True] and window.armed


def test_a_window_that_closes_at_a_unit_still_closes_at_a_prefill():
    window = Window(0.0, "unit")
    window.open()
    with pytest.raises(WindowClosed):
        window.at_unit(prefill=True)
    assert not window.armed


def test_the_prefill_units_are_the_read_s_and_guided_decode_s():
    assert PREFILLS == ("prefill", "prefill_topk")


def traced_at_once(tmp_path, monkeypatch, driver, spec, cell):
    """(result line, the driver's Run) of a traced run whose window is
    due before its first unit."""
    runs = []
    driver_run = driver.run
    monkeypatch.setattr(driver, "run",
                        lambda env: runs.append(driver_run(env)) or runs[-1])
    out = harness.run_cell(spec, cell, SEED, 0.0, True, CPU,
                           time.perf_counter())
    return out, runs[-1]


def test_a_read_traced_at_once_takes_its_first_admission_whole(
        tmp_path, monkeypatch):
    out, run = traced_at_once(tmp_path, monkeypatch, ocr,
                              tiny.make(tmp_path), "ocr.tiny")
    assert out["correct"], out["checks"]
    assert len(run.work.prompts) == 4            # 2 pages x 2 strategies
    assert run.counters["prefill_s"] > 0
    assert run.counters["decode_steps"] == 0 and not run.work.steps
    assert out["metrics"]["prefill_ms_per_ktok.ocr"]["value"] > 0


def test_a_round_traced_at_once_takes_its_first_admission_whole(
        tmp_path, monkeypatch):
    out, run = traced_at_once(tmp_path, monkeypatch, agents,
                              tiny_agents.make(tmp_path), "agents.tiny")
    assert out["correct"], out["checks"]
    assert len(run.work.prompts) == 3            # every turn admitted at once
    assert run.counters["prefill_s"] > 0
    assert run.counters["topk_steps"] == run.counters["string_steps"] == 0
    assert out["metrics"]["prefill_ms_per_ktok.agents"]["value"] > 0
