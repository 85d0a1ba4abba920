"""Ground-truth file parsing (copied from ``handwritten_ocr_tpu/text/gt.py``).

Contract: read a markdown file and return the
stripped text following the ``## Ground Truth`` header; if the header is
absent, the whole stripped file; None for a missing file or empty result.
"""

from __future__ import annotations

from pathlib import Path

_HEADER = "## Ground Truth"


def parse_ground_truth(file_path: str | Path) -> str | None:
    """Extract ground-truth text from a markdown/plain-text file."""
    path = Path(file_path)
    if not path.exists():
        return None
    raw = path.read_text(encoding="utf-8")
    pos = raw.find(_HEADER)
    text = raw.strip() if pos == -1 else raw[pos + len(_HEADER):].strip()
    return text or None
