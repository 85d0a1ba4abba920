"""Text normalization (copied from ``handwritten_ocr_tpu/text/normalize.py``).

Contract: curly quotes become straight quotes,
en/em dashes become hyphens, all whitespace runs collapse to single spaces,
leading/trailing whitespace is stripped, and optionally the text is
lowercased.
"""

from __future__ import annotations

import re

# Single-pass character translation for the punctuation folds.
_CHAR_FOLDS = str.maketrans({
    "‘": "'",   # left single curly quote
    "’": "'",   # right single curly quote
    "“": '"',   # left double curly quote
    "”": '"',   # right double curly quote
    "–": "-",   # en dash
    "—": "-",   # em dash
})

_WS_RUN = re.compile(r"\s+")


def normalize_text(text: str, lower: bool = False) -> str:
    """Fold curly punctuation, collapse whitespace, optionally lowercase."""
    out = _WS_RUN.sub(" ", text.translate(_CHAR_FOLDS)).strip()
    return out.lower() if lower else out
