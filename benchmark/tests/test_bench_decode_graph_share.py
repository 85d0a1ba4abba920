"""``decode_graph_share.ocr``, the share of the decode steps replayed
from a CUDA graph: its reader over the batcher's counters, and a traced
run of a tiny OCR cell on the CPU, where every step runs eagerly."""

from types import SimpleNamespace

import pytest

import tiny
from benchmark import harness
from test_bench_program_spans import traced  # noqa: F401  (a fixture)


@pytest.mark.parametrize("counters, share", [
    ({}, None), ({"decode_graph_steps": 3}, None),
    ({"decode_steps": 0, "decode_graph_steps": 0}, None),
    ({"decode_steps": 8}, None),
    ({"decode_steps": 8, "decode_graph_steps": 0}, 0.0),
    ({"decode_steps": 8, "decode_graph_steps": 6}, 75.0)],
    ids=["no_counters", "no_steps", "zero_steps", "no_replays", "eager",
         "graphed"])
def test_the_graph_share_reads_the_batcher_s_counters(counters, share):
    """None without ``decode_steps`` (or without the replay counter, as a
    program that has none), else the replayed steps' share in %."""
    read = harness.metric_reader(tiny.BENCH, "decode_graph_share.ocr")
    assert read(SimpleNamespace(counters=counters)) == share


def test_the_cpu_run_replays_no_step(traced):  # noqa: F811
    """On the CPU every step runs eagerly: the traced run reports a share
    of 0 over the steps it counted."""
    out, run, _ = traced
    assert run.counters["decode_steps"] > 0
    assert run.counters["decode_graph_steps"] == 0
    assert out["metrics"]["decode_graph_share.ocr"]["value"] == 0
