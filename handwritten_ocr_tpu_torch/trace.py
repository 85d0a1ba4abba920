"""Trace store: collects, prints, and persists pipeline events (copied
from ``handwritten_ocr_tpu/trace.py``).

Event schema and artifact formats are the JAX package's: ``save_json``
writes the full pretty-printed event list; ``save_summary`` writes one
``[MM:SS] summary`` line per event. :func:`profile_span` names a host
span in the ``torch.profiler`` timeline (``record_function``), as the JAX
package's names one in ``jax.profiler``'s.
"""

from __future__ import annotations

import contextlib
import json
import time
from datetime import datetime, timezone
from pathlib import Path


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

    def print_summary(self) -> None:
        for e in self.events:
            print(f"[{_mmss(e['elapsed_seconds'])}] {e['output_summary']}")

    @classmethod
    def from_events(cls, events: list[dict]) -> "Trace":
        """Rebuild a trace from pre-built event dicts (driver hand-off)."""
        trace = cls()
        trace.events = list(events)
        return trace


def _mmss(seconds: float) -> str:
    minutes, secs = divmod(int(seconds), 60)
    return f"{minutes:02d}:{secs:02d}"


@contextlib.contextmanager
def profile_span(name: str):
    """Annotate a host-side span in the ``torch.profiler`` timeline; costs
    next to nothing while no profiler is recording."""
    import torch
    with torch.profiler.record_function(name):
        yield
