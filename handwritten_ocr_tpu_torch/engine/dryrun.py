"""Dry-run backends: deterministic, model-free engine stack (copied from
``handwritten_ocr_tpu/engine/dryrun.py``).

``python -m handwritten_ocr_tpu_torch --backend dryrun`` exercises the
full pipeline — preprocessing labels, batched reads, critic routing,
artifacts — without any model weights. The OCR "transcription" is derived
from the image bytes (stable across runs), and the reasoning backend
accepts on the first critique. Useful for smoke tests, CI, and demos on
machines without weights.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Sequence


class DryRunOCRBackend:
    """Returns a deterministic pseudo-transcription per (image, strategy)."""

    def read_batch(self, images: Sequence, prompt: str, max_new_tokens: int) -> list[str]:
        out = []
        for image in images:
            source = getattr(image, "source_path", str(image))
            digest = _digest(source)
            out.append(
                f"[dryrun transcription of {Path(source).name} | {digest}]"
            )
        return out

    def read(self, image, prompt: str, max_new_tokens: int) -> str:
        return self.read_batch([image], prompt, max_new_tokens)[0]

    def release(self) -> None:
        pass


class DryRunReasoningBackend:
    """Always accepts with high confidence (single-iteration runs)."""

    def chat(self, system_prompt: str, user_message: str, *,
             temperature: float, max_tokens: int,
             json_schema: dict | None = None) -> str:
        if "arbitrator" in system_prompt.lower():
            # Keep version 1 (the current best) verbatim.
            return json.dumps({"final_text": _section(user_message, "## Version 1"),
                               "confidence": 90,
                               "decisions": [], "uncertain_segments": []})
        if "editor" in system_prompt.lower():
            # Echo the transcription back unchanged.
            return json.dumps({"corrected_text": _section(user_message, "## Transcription"),
                               "changes": [], "unresolved": []})
        return json.dumps({
            "overall_confidence": 90,
            "segments": [],
            "verdict": "accept",
            "reasoning": "dry-run: auto-accept",
        })


def _section(message: str, header: str) -> str:
    """Text of one ``## ...`` block (drops the header's own line)."""
    start = message.find(header)
    if start == -1:
        return ""
    body_start = message.find("\n", start) + 1
    end = message.find("\n##", body_start)
    body = message[body_start:] if end == -1 else message[body_start:end]
    return body.strip()


def _digest(source: str) -> str:
    path = Path(source)
    if path.exists():
        return hashlib.sha256(path.read_bytes()).hexdigest()[:12]
    return hashlib.sha256(source.encode()).hexdigest()[:12]
