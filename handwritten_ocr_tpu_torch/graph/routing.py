"""Conditional-edge routing functions (copied from
``handwritten_ocr_tpu/graph/routing.py``).

The precedence order is load-bearing and must not be reordered:
  1. verdict "accept" OR confidence >= accept_threshold  → accept
  2. plateau_count >= plateau_patience                   → plateau
  3. iteration >= max_iterations                         → max_iterations
  4. verdict "needs_reocr"                               → reocr
  5. otherwise                                           → edit
"""

from __future__ import annotations

from handwritten_ocr_tpu_torch.state import OCRState


def route_after_critic(state: OCRState) -> str:
    """Decide the next step after the critic evaluates the transcription."""
    latest = state["critiques"][-1]
    confidence = latest["overall_confidence"]
    verdict = latest["verdict"]

    if verdict == "accept" or confidence >= state["config"]["accept_threshold"]:
        return "accept"
    if state["plateau_count"] >= state["config"]["plateau_patience"]:
        return "plateau"
    if state["iteration"] >= state["max_iterations"]:
        return "max_iterations"
    if verdict == "needs_reocr":
        return "reocr"
    return "edit"


def route_after_reocr(state: OCRState) -> str:
    """After re-OCR: strategies exhausted ends the run, else back to critic."""
    if state.get("reason") == "exhausted":
        return "max_iterations"
    return "critic"
