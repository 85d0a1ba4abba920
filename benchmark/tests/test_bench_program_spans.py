"""The per-layer metrics that read the port's own host spans and step
counters, over a whole run of a tiny OCR cell on the CPU with a CPU
profiler where a card's run has its device trace: started by the
harness's ``start_trace`` and stopped (``_disable_profiler``) where its
trace stops. The program's counts are held against the harness's own
reconstruction of the decode steps from outside."""

import time

import pytest
import torch

import tiny
from benchmark import harness
from benchmark.drivers import ocr
from handwritten_ocr_tpu_torch import trace

READERS = ("decode_dispatch_ms_per_step.ocr", "decode_wait_ms_per_step.ocr",
           "decode_live_slots.ocr", "ocr.deskew_search_ms_per_read")


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """(result line, the driver's Run, the host spans kept) of one traced
    run. One page under deskew alone keeps a folder short under the
    profiler, and the window (10 s) outlasts the first folder, so its
    decode chunks are traced whole."""
    start, stop = harness.Env.start_trace, harness.Env.stop_trace

    def start_trace(env):
        start(env)
        torch.autograd.profiler.profile(use_kineto=True,
                                        use_cpu=True).__enter__()

    def stop_trace(env, ranges, t_open, t_close):
        torch.autograd._disable_profiler()
        stop(env, ranges, t_open, t_close)

    runs = []
    driver_run = ocr.run
    cells = {"ocr.tiny": ("tiny-vl", tiny.ocr_cell(pages=1,
                                                   strategies=[["deskew"]]))}
    spec = tiny.make(tmp_path_factory.mktemp("spans"), cells)
    trace.host_spans().clear()
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(harness.Env, "start_trace", start_trace)
        patch.setattr(harness.Env, "stop_trace", stop_trace)
        patch.setattr(ocr, "run",
                      lambda env: runs.append(driver_run(env)) or runs[-1])
        out = harness.run_cell(spec, "ocr.tiny", 2**31 + 11, 10.0, True,
                               torch.device("cpu"), time.perf_counter())
    spans = list(trace.host_spans())
    trace.host_spans().clear()
    # the flag a profiler stopped by _disable_profiler leaves set
    torch.autograd.profiler._is_profiler_enabled = False
    return out, runs[-1], spans


def test_the_readers_of_the_program_s_spans_return_numbers(traced):
    out, _, _ = traced
    assert out["correct"], out["checks"]
    for name in READERS:
        assert out["metrics"][name]["value"] > 0, name
    # the tiny cell's folder is one read: one slot live at every step
    assert out["metrics"]["decode_live_slots.ocr"]["value"] == 1


def test_the_program_counts_the_steps_the_harness_reckons(traced):
    _, run, spans = traced
    steps = run.counters["decode_steps"]
    assert steps == len(run.work.steps) > 0
    assert run.counters["decode_slot_steps"] == run.work.live
    t_open = run.window.t_open * 1e9
    assert all(start >= t_open for _, start, _ in spans)
    assert sum(name == "decode.step" for name, *_ in spans) == steps
    assert sum(name == "preprocess.deskew_angle" for name, *_ in spans) \
        == len(run.work.grids)
