"""Robust JSON extraction from LLM responses (copied from
``handwritten_ocr_tpu/utils/jsonio.py``).

Contract: strip leading/trailing markdown code
fences, try a direct parse, then scan for the first balanced ``{...}`` block
and then the first balanced ``[...]`` block; return None when nothing
parses.
"""

from __future__ import annotations

import json
import re

_FENCE_OPEN = re.compile(r"^```(?:json)?\s*")
_FENCE_CLOSE = re.compile(r"\s*```$")


def extract_json(raw: str) -> dict | list | None:
    """Parse JSON out of an LLM response; None if unrecoverable."""
    cleaned = _FENCE_CLOSE.sub("", _FENCE_OPEN.sub("", raw.strip()))

    try:
        return json.loads(cleaned)
    except json.JSONDecodeError:
        pass

    for opener, closer in (("{", "}"), ("[", "]")):
        block = _balanced_span(cleaned, opener, closer)
        if block is not None:
            try:
                return json.loads(block)
            except json.JSONDecodeError:
                continue
    return None


def _balanced_span(text: str, opener: str, closer: str) -> str | None:
    """First balanced opener...closer span of ``text``, or None."""
    start = text.find(opener)
    if start == -1:
        return None
    depth = 0
    for pos in range(start, len(text)):
        ch = text[pos]
        if ch == opener:
            depth += 1
        elif ch == closer:
            depth -= 1
            if depth == 0:
                return text[start : pos + 1]
    return None
