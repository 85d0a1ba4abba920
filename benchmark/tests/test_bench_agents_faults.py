"""The agent cell's comparison, driven through whole runs of a tiny
critic round on the CPU with guided decode broken underneath: each fault
the cell can have turns ``correct`` false, and sound runs stay true. A
traced run gives every per-layer number that does not need a card's
trace, and the harness's count of the guided steps agrees with the
program's. (The control, and the faults at the cell's own size, run on
the card: ``test_bench_agents_control.py``.)"""

import contextlib
import time

import pytest
import torch

import tiny_agents
from benchmark import harness
from benchmark.drivers import agents
from faults import stale_cache
from faults_agents import one_altered_string_token, wrong_choice

CPU = torch.device("cpu")
SEED = 2**31 + 5


def run(tmp_path, cell=None, faults=(), trace=False):
    cells = {"agents.tiny": ("tiny-qwen3", cell or tiny_agents.agents_cell())}
    spec = tiny_agents.make(tmp_path, cells)
    return harness.run_cell(spec, "agents.tiny", SEED, 1.0, trace, CPU,
                            time.perf_counter(), faults=faults)


def test_a_sound_round_is_correct(tmp_path):
    out = run(tmp_path)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] == 3
    assert out["checks"]["max_logit_gap"]["value"] < 0.1
    assert out["checks"]["replay_mismatches"]["value"] == 0
    assert set(out["metrics"]) == {"agent_turns_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["wrong_choice", "one_string_token",
                                   "stale"])
def test_each_fault_of_the_agent_cell_turns_correct_false(tmp_path, fault):
    faults = {"wrong_choice": (wrong_choice(),),
              "one_string_token": (one_altered_string_token(),),
              "stale": ()}[fault]
    scope = stale_cache if fault == "stale" else contextlib.nullcontext
    with scope():
        out = run(tmp_path, faults=faults)
    assert not out["correct"], out["checks"]


def test_one_wrong_choice_fails_the_choice_gap_alone(tmp_path):
    """Held to the choice gap only, one wrong choice a turn still fails:
    the string tokens after it, teacher-forced on its prefix, agree with
    the reference."""
    cell = tiny_agents.agents_cell(limits={"max_choice_gap": 0.25})
    sound = run(tmp_path / "sound", cell)
    broken = run(tmp_path / "broken", cell, faults=(wrong_choice(),))
    assert sound["correct"], sound["checks"]
    assert not broken["correct"], broken["checks"]
    assert broken["checks"]["replay_mismatches"]["value"] == 0


def test_a_traced_round_reads_the_layers_and_counts_the_program_s_steps(
        tmp_path, monkeypatch):
    runs = []
    driver_run = agents.run
    monkeypatch.setattr(agents, "run",
                        lambda env: runs.append(driver_run(env)) or runs[-1])
    # the trace stops at the first unit past --seconds: 8 s hold the
    # first round, whose last 20 tokens a turn are string steps
    cells = {"agents.tiny": ("tiny-qwen3",
                             tiny_agents.agents_cell(max_tokens=64))}
    spec = tiny_agents.make(tmp_path, cells)
    out = harness.run_cell(spec, "agents.tiny", SEED, 8.0, True, CPU,
                           time.perf_counter())
    assert out["correct"], out["checks"]
    for name in ("prefill_ms_per_ktok.agents", "guided.topk_step_ms.agents",
                 "guided.string_step_ms.agents",
                 "guided.tokens_per_step.agents",
                 "guided.session_ms_per_token.agents"):
        assert out["metrics"][name]["value"] > 0, name
    # no device trace on the CPU: the device's numbers read nothing
    assert "mfu.agents" not in out["metrics"]
    counted = runs[-1]
    steps = counted.counters["topk_steps"] + counted.counters["string_steps"]
    assert len(counted.work.steps) == steps > 0
    assert len(counted.work.prompts) == counted.counters["sessions"] >= 3
