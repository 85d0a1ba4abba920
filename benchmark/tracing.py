"""The harness's own ranges and the device trace of a ``--trace 1`` run.

Ranges are host intervals around the calls the harness makes into each
layer of the program (preprocess, vision, prefill, a decode chunk),
recorded with the host clock; in a traced run each is also
a ``torch.profiler.record_function`` range. The device side comes from
``torch.profiler`` with CUDA activity only (the CPU side of every
operator would slow the host far more), read from its raw events:

- busy time is the union of the intervals in which any kernel, copy or
  memset ran, so overlapping streams are counted once;
- kernel time by name, for the rooflines;
- idle gaps, each labelled by the innermost harness range the host was
  in at the gap's midpoint. Device timestamps are mapped onto the host
  clock through two anchor kernels (``torch.cuda._sleep``) launched at
  known host times at the start and the end of the window, the first and
  the last activity the trace holds.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

ANCHOR = "spin_kernel"


class Ranges:
    """Host intervals by name; nested calls are kept as they come, until
    ``frozen`` (the trace has stopped)."""

    def __init__(self, profile: bool):
        self.profile = profile
        self.frozen = False
        self.spans: list[tuple[str, int, int]] = []
        self.totals: dict[str, list] = defaultdict(lambda: [0.0, 0])

    @contextlib.contextmanager
    def range(self, name: str, sync: bool = False):
        start = time.perf_counter_ns()
        scope = torch.profiler.record_function(name) if self.profile \
            else contextlib.nullcontext()
        try:
            with scope:
                yield
                if sync and torch.cuda.is_available():
                    torch.cuda.synchronize()
        finally:
            end = time.perf_counter_ns()
            if not self.frozen:
                self.spans.append((name, start, end))
                total = self.totals[name]
                total[0] += (end - start) / 1e9
                total[1] += 1

    def seconds(self, name: str) -> float:
        return self.totals[name][0] if name in self.totals else 0.0


class DeviceTrace:
    """The profiler over the window (device activity only), with
    host-clock anchors. It is stopped with ``_disable_profiler`` and its
    raw events read as they are, without the event tree that
    ``torch.profiler``'s own exit builds of every launch."""

    def __init__(self):
        from torch.autograd import profiler
        self.prof = profiler.profile(use_kineto=True, use_device="cuda",
                                     use_cpu=False)
        self.results = None
        self.anchors: list[int] = []

    def _anchor(self) -> None:
        torch.cuda.synchronize()
        self.anchors.append(time.perf_counter_ns())
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def start(self) -> None:
        self.prof.__enter__()
        self._anchor()

    def stop(self) -> None:
        self._anchor()
        torch.cuda.synchronize()
        self.results = torch.autograd._disable_profiler()

    def events(self) -> list[tuple[str, int, int]]:
        """(name, start ns, end ns) of every device activity, on the host
        clock."""
        raw = []
        for e in self.results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA or \
                    e.is_user_annotation() or e.duration_ns() <= 0:
                continue
            raw.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        # The anchors are the window's first and last device activity (the
        # device's clock counts from the epoch, the host's does not). Where
        # the profiler drops one, the kernel next to it stands in, some
        # milliseconds off; matched by name, a lost anchor left the whole
        # trace outside its window.
        if raw and len(self.anchors) == 2:
            first = min(s for _, s, _ in raw)
            last = max(s for _, s, _ in raw)
            offset = ((first - self.anchors[0]) + (last - self.anchors[1])) / 2
        else:
            offset = 0
        return [(name, int(s - offset), int(e - offset))
                for name, s, e in raw if ANCHOR not in name]


def summarize(events, spans, window: tuple[int, int]) -> dict:
    """Busy seconds (the union of the activity intervals), kernel seconds
    by name and idle seconds by the host's range, inside ``window`` (host
    ns)."""
    lo, hi = window
    inside = [(n, max(s, lo), min(e, hi)) for n, s, e in events
              if e > lo and s < hi]
    by_name: dict[str, float] = defaultdict(float)
    for name, s, e in inside:
        by_name[name] += (e - s) / 1e9
    merged: list[list[int]] = []
    for s, e in sorted((s, e) for _, s, e in inside):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps = [(s, e) for s, e in zip([lo] + [m[1] for m in merged],
                                   [m[0] for m in merged] + [hi]) if e > s]
    return {"busy_s": sum(e - s for s, e in merged) / 1e9,
            "window_s": (hi - lo) / 1e9, "kernels": dict(by_name),
            "idle": _label(gaps, spans)}


def _label(gaps, spans) -> dict[str, float]:
    """Idle seconds by the innermost range the host was in at each gap's
    midpoint (the ranges nest: they are context managers on one
    thread)."""
    bounds = sorted([(s, 1, i) for i, (_, s, _) in enumerate(spans)]
                    + [(e, 0, i) for i, (_, _, e) in enumerate(spans)])
    idle: dict[str, float] = defaultdict(float)
    stack: list[int] = []
    k = 0
    for start, end in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (start + end) // 2
        while k < len(bounds) and bounds[k][0] <= mid:
            _, opening, index = bounds[k]
            if opening:
                stack.append(index)
            elif index in stack:
                stack.remove(index)
            k += 1
        label = spans[stack[-1]][0] if stack else "outside the harness's ranges"
        idle[label] += (end - start) / 1e9
    return dict(idle)


def breakdown(summary: dict) -> dict:
    top = sorted(summary["kernels"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(summary["idle"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[name[:160], secs] for name, secs in top],
            "idle_gaps": [[name, secs] for name, secs in gaps]}


def kernel_seconds(summary: dict, names) -> float | None:
    """Device seconds of the kernels whose name holds any of ``names``;
    None where none ran."""
    hits = [secs for kernel, secs in summary["kernels"].items()
            if any(n in kernel for n in names)]
    return sum(hits) if hits else None
