"""The agent cell's comparison at the cell's own size on the card:

- the control, the program on the same weights rounded to int4 levels
  per output channel (``--control 1``), must come out as not correct on
  every seed;
- one wrong choice a turn (``faults_agents.wrong_choice``), one altered
  string token a turn (``faults_agents.one_altered_string_token``) and a
  step that returns its state unchanged (``faults.stale_cache``) must
  come out as not correct too: the first two read the upper ends of the
  choice gap's and the widest gap's limits.

Each case is a whole run of one round (``--seconds`` 1: the cell closes
at a round's end); the numbers compared are printed:

    python -m pytest --noconftest -m cuda -s \\
        benchmark/tests/test_bench_agents_control.py
"""

import contextlib
import time
from pathlib import Path

import pytest
import torch

from benchmark import harness
from faults import stale_cache
from faults_agents import one_altered_string_token, wrong_choice

SPEC = Path(__file__).resolve().parents[2] / "BENCHMARK.json"
SEEDS = (2**31 + 201, 2**31 + 202, 2**31 + 203)
CELL = "agents.critic48"


def card():
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's own size, on a CUDA card")
    from handwritten_ocr_tpu_torch.ops import build
    build.build_all()
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_is_not_correct(seed):
    out = harness.run_cell(SPEC, CELL, seed, 1, False, card(),
                           time.perf_counter(), control=True)
    print(CELL, seed, "control", out["checks"])
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["wrong_choice", "one_string_token",
                                   "stale"])
@pytest.mark.parametrize("seed", SEEDS)
def test_each_fault_at_the_cell_s_size_is_not_correct(seed, fault):
    planted = {"wrong_choice": (wrong_choice(),),
               "one_string_token": (one_altered_string_token(),),
               "stale": ()}[fault]
    scope = stale_cache if fault == "stale" else contextlib.nullcontext
    with scope():
        out = harness.run_cell(SPEC, CELL, seed, 1, False, card(),
                               time.perf_counter(), faults=planted)
    print(CELL, seed, fault, out["checks"])
    assert not out["correct"], out["checks"]
