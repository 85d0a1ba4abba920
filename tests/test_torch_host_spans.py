"""The port's host spans (``trace.profile_span`` / ``trace.host_spans``)
and the batcher's step counters, on the CPU.

A span is kept only while a profiler records, and the profiler is
stopped here as the benchmark's traced runs stop theirs, with
``torch.autograd._disable_profiler``, after which the Python-level flag
still reads True: only the C-level state tells a stopped profiler."""

import time
from unittest import mock

import numpy as np
import pytest
import torch

from handwritten_ocr_tpu_torch import trace
from handwritten_ocr_tpu_torch.engine.serving import (ContinuousBatcher,
                                                      GenRequest, PagedProgram)
from handwritten_ocr_tpu_torch.models.init import init_vl
from handwritten_ocr_tpu_torch.models.qwen25vl.config import (TextConfig,
                                                              VLConfig)
from handwritten_ocr_tpu_torch.ops.bank import apply_deskew

TEXT = TextConfig(vocab_size=300, hidden_size=64, intermediate_size=96,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, mrope_section=(2, 3, 3))
BUDGETS = (12, 7, 12, 9, 4)


@pytest.fixture(autouse=True)
def no_spans():
    trace.host_spans().clear()
    yield
    trace.host_spans().clear()
    # the flag a profiler stopped by _disable_profiler leaves set
    torch.autograd.profiler._is_profiler_enabled = False


def start_profiler():
    """A CPU profiler started as the harness starts its device trace."""
    torch.autograd.profiler.profile(use_kineto=True, use_cpu=True).__enter__()


def stop_profiler():
    torch.autograd._disable_profiler()


def named(name):
    return [span for span in trace.host_spans() if span[0] == name]


def requests():
    rng = np.random.default_rng(3)
    out = []
    for n, budget in zip((5, 11, 19, 3, 30), BUDGETS):
        ids = rng.integers(10, 300, n).astype(np.int32)
        positions = np.broadcast_to(np.arange(n), (3, n)).astype(np.int64)
        out.append(GenRequest(prompt_ids=ids, max_new=budget,
                              positions=positions))
    return out


@pytest.fixture(scope="module")
def text():
    return init_vl(VLConfig(text=TEXT), dtype=torch.float32, device="cpu",
                   seed=1)["text"]


def batcher(text, eos):
    return ContinuousBatcher(PagedProgram(text, TEXT, eos_token_id=eos),
                             dtype=torch.float32, device="cpu", n_slots=2,
                             block_size=8, max_context=96, chunk=5,
                             prefill_bucket=16)


def test_no_profiler_keeps_no_span_and_opens_no_record_function():
    with mock.patch.object(torch.profiler, "record_function") as opened:
        first = trace.profile_span("decode.step")
        with first:
            pass
        with trace.profile_span("decode.sync"):
            pass
    opened.assert_not_called()
    assert first is trace.profile_span("preprocess.deskew_angle")
    assert trace.host_spans() == []


def test_a_stopped_profiler_reads_as_stopped():
    start_profiler()
    with trace.profile_span("decode.step"):
        pass
    stop_profiler()
    assert torch.autograd.profiler._is_profiler_enabled
    with trace.profile_span("decode.step"):
        pass
    assert len(named("decode.step")) == 1


def test_decode_spans_count_the_batcher_s_steps(text):
    # An EOS that the greedy streams reach mid-read: the fourth request's
    # fifth token under an EOS none of them emits.
    eos = batcher(text, 7).run(requests())[3][4]
    run = batcher(text, eos)
    calls = []
    step = run.program._step
    run.program._step = lambda *a, **k: calls.append(1) or step(*a, **k)
    before = time.perf_counter_ns()
    start_profiler()
    got = run.run(requests())
    stop_profiler()
    after = time.perf_counter_ns()
    stats = run.stats
    assert stats["decode_steps"] == len(calls) > 0
    assert len(named("decode.step")) == stats["decode_steps"]
    # a flag read before each step, and the tokens' read after each chunk
    assert len(named("decode.sync")) > stats["decode_steps"]
    assert all(before <= s <= e <= after for _, s, e in trace.host_spans())
    # each read that reached decode: its tokens after the prefill's first,
    # and the step that emitted its EOS
    by_eos = [len(t) < b for t, b in zip(got, BUDGETS)]
    assert any(by_eos)
    assert stats["decode_slot_steps"] == sum(
        len(t) - 1 + stop for t, b, stop in zip(got, BUDGETS, by_eos)
        if t and b > 1)
    kept = len(trace.host_spans())
    run.run(requests())
    assert len(trace.host_spans()) == kept


@pytest.mark.parametrize("page", ["text", "blank"])
def test_deskew_keeps_one_span_of_its_angle_search(page):
    image = torch.full((120, 160), 255, dtype=torch.uint8)
    if page == "text":
        image[40:50, 20:140] = 0
    start_profiler()
    apply_deskew(image)
    stop_profiler()
    assert [s[0] for s in trace.host_spans()] == ["preprocess.deskew_angle"]
