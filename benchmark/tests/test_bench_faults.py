"""The comparison that decides ``correct``, driven through a whole run of
the tiny OCR cell (one folder) with the timed path broken underneath:
each fault the cell can have must turn ``correct`` false, and sound runs
must stay true. (The control, the comparison's other witness, and the
one-token fault run at the cells' own size on the card:
``test_bench_control.py``.)"""

import contextlib
import time

import pytest
import torch

import tiny
from benchmark import harness
from faults import altered_token, one_altered_token, stale_cache

CPU = torch.device("cpu")


def run(tmp_path, cell, faults=(), seconds=1.0, seed=2**31 + 5):
    spec = tiny.make(tmp_path)
    return harness.run_cell(spec, cell, seed, seconds, False, CPU,
                            time.perf_counter(), faults=faults)


def test_sound_ocr_runs_are_correct(tmp_path):
    out = run(tmp_path, "ocr.tiny")
    assert out["correct"], out["checks"]
    assert out["checks"]["max_logit_gap"]["value"] < 0.1


@pytest.mark.parametrize("fault", ["token", "one_token", "stale"])
def test_each_fault_of_the_ocr_cells_turns_correct_false(tmp_path, fault):
    faults = {"token": (altered_token,), "one_token": (one_altered_token(),),
              "stale": ()}[fault]
    scope = stale_cache if fault == "stale" else contextlib.nullcontext
    with scope():
        out = run(tmp_path, "ocr.tiny", faults)
    assert not out["correct"], out["checks"]


def test_one_wrong_token_fails_the_widest_gap_alone(tmp_path):
    """Held to the widest gap only, the one-token fault still fails: the
    mean is not what catches it."""
    cells = {"ocr.tiny": ("tiny-vl", tiny.ocr_cell(
        limits={"max_logit_gap": 0.25}))}
    spec = tiny.make(tmp_path, cells)
    sound = harness.run_cell(spec, "ocr.tiny", 2**31 + 5, 1.0, False, CPU,
                             time.perf_counter())
    broken = harness.run_cell(spec, "ocr.tiny", 2**31 + 5, 1.0, False, CPU,
                              time.perf_counter(),
                              faults=(one_altered_token(),))
    assert sound["correct"] and not broken["correct"], broken["checks"]
