"""The comparison's witnesses at the cells' own size on the card:

- the control, the port's own int8-weight path (one precision below the
  configuration's bf16), must come out as not correct on every seed,
  where sound runs of the same seeds do not;
- one token altered in each read (``faults.one_altered_token``) must come
  out as not correct too: the reading that sets the upper end of the
  widest gap's limit.

Each case is a whole run over one folder (``--seconds`` 1, and the cells
close at a folder's end); the numbers compared are printed:

    python -m pytest --noconftest -m cuda -s benchmark/tests/test_bench_control.py
"""

import time
from pathlib import Path

import pytest
import torch

from benchmark import harness
from faults import one_altered_token

SPEC = Path(__file__).resolve().parents[2] / "BENCHMARK.json"
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)
CELLS = ["ocr.notebook48", "ocr.notes12"]


def card():
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cells' own size, on a CUDA card")
    from handwritten_ocr_tpu_torch.ops import build
    build.build_all()
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_is_not_correct(cell, seed):
    out = harness.run_cell(SPEC, cell, seed, 1, False, card(),
                           time.perf_counter(), control=True)
    print(cell, seed, "control", out["checks"])
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_one_altered_token_in_each_read_is_not_correct(cell, seed):
    out = harness.run_cell(SPEC, cell, seed, 1, False, card(),
                           time.perf_counter(),
                           faults=(one_altered_token(),))
    print(cell, seed, "one altered token", out["checks"])
    assert not out["correct"], out["checks"]
