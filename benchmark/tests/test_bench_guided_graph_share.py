"""``guided.graph_share.agents``, the share of guided decode's steps
replayed from a CUDA graph: its reader over the batcher's counters."""

from types import SimpleNamespace

import pytest

import tiny
from benchmark import harness


@pytest.mark.parametrize("counters, share", [
    ({}, None), ({"guided_graph_steps": 3}, None),
    ({"topk_steps": 0, "string_steps": 0, "guided_graph_steps": 0}, None),
    ({"topk_steps": 5, "string_steps": 3}, None),
    ({"topk_steps": 5, "string_steps": 3, "guided_graph_steps": 0}, 0.0),
    ({"topk_steps": 5, "string_steps": 3, "guided_graph_steps": 6}, 75.0),
    ({"topk_steps": 8, "guided_graph_steps": 6}, 75.0)],
    ids=["no_counters", "no_steps", "zero_steps", "no_replays", "eager",
         "graphed", "topk_only"])
def test_the_guided_graph_share_reads_the_batcher_s_counters(counters, share):
    """None without guided steps (or without the replay counter, as a
    program that has none), else the replayed steps' share in %."""
    read = harness.metric_reader(tiny.BENCH, "guided.graph_share.agents")
    assert read(SimpleNamespace(counters=counters)) == share
