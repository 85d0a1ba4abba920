"""The port's own host spans over a traced window: the intervals
``handwritten_ocr_tpu_torch.trace.profile_span`` keeps while a profiler
records (the device trace's window, on the ``perf_counter_ns`` clock its
anchors use), for the per-layer readers that read them."""

from __future__ import annotations


def seconds(m, name: str) -> float | None:
    """Host seconds of the spans ``name`` that start at or after the
    window's opening; None where the program kept none (no profiler
    recorded, or a program without host spans)."""
    from handwritten_ocr_tpu_torch import trace
    host_spans = getattr(trace, "host_spans", None)
    if host_spans is None:
        return None
    t_open = m.run.window.t_open * 1e9
    found = [end - start for span, start, end in host_spans()
             if span == name and start >= t_open]
    return sum(found) / 1e9 if found else None
