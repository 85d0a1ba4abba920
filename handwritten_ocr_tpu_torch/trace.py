"""Trace store: collects, prints, and persists pipeline events (copied
from ``handwritten_ocr_tpu/trace.py``).

Event schema and artifact formats are the JAX package's: ``save_json``
writes the full pretty-printed event list; ``save_summary`` writes one
``[MM:SS] summary`` line per event. :func:`profile_span` names a host
span in the ``torch.profiler`` timeline (``record_function``), as the JAX
package's names one in ``jax.profiler``'s, and keeps its host-clock
interval for :func:`host_spans` while a profiler records.
"""

from __future__ import annotations

import contextlib
import json
import time
from datetime import datetime, timezone
from pathlib import Path

import torch


class Trace:
    """Collects timestamped events throughout a pipeline run."""

    def __init__(self) -> None:
        self.events: list[dict] = []
        self._start_time = time.monotonic()

    # ── event creation ────────────────────────────────────────────
    def log(
        self,
        iteration: int,
        agent: str,
        action: str,
        input_summary: str,
        output_summary: str,
        full_input: dict | None = None,
        full_output: dict | None = None,
        metrics: dict | None = None,
        decision: str | None = None,
    ) -> None:
        event = {
            "timestamp": datetime.now(timezone.utc).isoformat(),
            "elapsed_seconds": round(time.monotonic() - self._start_time, 1),
            "iteration": iteration,
            "agent": agent,
            "action": action,
            "input_summary": input_summary,
            "output_summary": output_summary,
            "full_input": full_input or {},
            "full_output": full_output or {},
            "metrics": metrics or {},
            "decision": decision,
        }
        self.events.append(event)
        print(f"[{_mmss(event['elapsed_seconds'])}] {output_summary}")

    # ── persistence ───────────────────────────────────────────────
    def save_json(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(
            json.dumps(self.events, indent=2, ensure_ascii=False), encoding="utf-8"
        )

    def save_summary(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        lines = [f"[{_mmss(e['elapsed_seconds'])}] {e['output_summary']}" for e in self.events]
        path.write_text("\n".join(lines) + "\n", encoding="utf-8")

    @classmethod
    def from_events(cls, events: list[dict]) -> "Trace":
        """Rebuild a trace from pre-built event dicts (driver hand-off)."""
        trace = cls()
        trace.events = list(events)
        return trace


def _mmss(seconds: float) -> str:
    minutes, secs = divmod(int(seconds), 60)
    return f"{minutes:02d}:{secs:02d}"


# (name, start ns, end ns) of every span closed while a profiler recorded,
# on the ``time.perf_counter_ns`` clock; see ``profile_span``.
_HOST_SPANS: list[tuple[str, int, int]] = []
_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


@contextlib.contextmanager
def _kept(name: str):
    with torch.profiler.record_function(name):
        start = time.perf_counter_ns()
        try:
            yield
        finally:
            _HOST_SPANS.append((name, start, time.perf_counter_ns()))


def profile_span(name: str):
    """A named host span, recorded only while a profiler records.

    With no profiler recording (the C-level state, which reads False as
    soon as a profiler is stopped by ``torch.autograd._disable_profiler``)
    it returns a shared no-op context and costs one check. While one
    records it opens ``torch.profiler.record_function(name)``, so the
    span shows in the profiler's timeline (``--profile DIR``), and keeps
    ``(name, start_ns, end_ns)`` on the ``time.perf_counter_ns`` clock
    for :func:`host_spans`.

    The port's spans: ``decode.step`` (one decode step's enqueue: the
    forward, or its CUDA graph's replay, the token write and the done
    update), ``decode.sync``
    (every host read that waits on decode work: the per-step done flag,
    the chunk's tokens at its end) and ``preprocess.deskew_angle``
    (deskew's angle search on the host). They never nest."""
    return _kept(name) if _recording() else _OFF


def host_spans() -> list[tuple[str, int, int]]:
    """The spans :func:`profile_span` kept, in the order they ended (the
    list itself: ``host_spans().clear()`` empties it)."""
    return _HOST_SPANS
