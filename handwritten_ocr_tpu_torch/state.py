"""Pipeline state and in-node trace event factory (copied from
``handwritten_ocr_tpu/state.py``).

``OCRState`` is the value-passed state flowing through the host-side
graph driver. ``trace_log`` builds one trace event dict with the JAX
package's schema and prints the live ``[MM:SS]`` log line.
"""

from __future__ import annotations

import time
from datetime import datetime, timezone
from typing import Any, TypedDict


class OCRState(TypedDict):
    """Full state flowing through the OCR pipeline graph."""

    image_path: str
    candidates: list[dict]      # {text, source, ocr_params, score}
    critiques: list[dict]       # CriticResult dicts
    edits: list[dict]           # EditorResult dicts
    current_best: str
    current_score: float
    iteration: int
    max_iterations: int
    status: str                 # "running" | "completed" | "max_iterations"
    reason: str                 # "accept" | "plateau" | "exhausted" | "max_iterations" | ""
    strategies_used: list[str]
    plateau_count: int
    prev_score: float
    prev_critique: dict | None
    config: dict                # accept_threshold, plateau_patience, strategies, agreement_threshold
    trace_events: list[dict]
    start_time: float


def initial_state(
    image_path: str,
    *,
    config: dict,
    max_iterations: int,
    start_time: float | None = None,
) -> OCRState:
    """Fresh pipeline state."""
    return OCRState(
        image_path=str(image_path),
        candidates=[],
        critiques=[],
        edits=[],
        current_best="",
        current_score=0.0,
        iteration=0,
        max_iterations=max_iterations,
        status="running",
        reason="",
        strategies_used=[],
        plateau_count=0,
        prev_score=0.0,
        prev_critique=None,
        config=config,
        trace_events=[],
        start_time=start_time if start_time is not None else time.monotonic(),
    )


def trace_log(
    state: OCRState,
    *,
    iteration: int,
    agent: str,
    action: str,
    input_summary: str,
    output_summary: str,
    full_input: dict | None = None,
    full_output: dict | None = None,
    metrics: dict | None = None,
    decision: str | None = None,
    quiet: bool = False,
) -> dict[str, Any]:
    """Create one trace event (schema byte-compatible with the JAX package's).

    Also prints a live ``[MM:SS] summary`` line unless ``quiet`` (the batch
    runner silences per-page chatter when pages run in parallel).
    """
    elapsed = round(time.monotonic() - state["start_time"], 1)
    event = {
        "timestamp": datetime.now(timezone.utc).isoformat(),
        "elapsed_seconds": elapsed,
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
    if not quiet:
        minutes, seconds = divmod(int(elapsed), 60)
        print(f"[{minutes:02d}:{seconds:02d}] {output_summary}")
    return event
