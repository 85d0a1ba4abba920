"""Candidate comparison: agreement rate and word-level differing segments
(copied from ``handwritten_ocr_tpu/text/diff.py``).

Contract: ``compare_versions`` reports
  * ``agreement_rate`` — round((1 - char_edits / max(|n1|, |n2|, 1)) * 100, 1)
    over the normalized texts,
  * character and word edit distances, and
  * ``differing_segments`` — a greedy word-aligned diff that walks both word
    sequences, resynchronizing with a bounded 10-word lookahead (v1-side
    lookahead checked before v2-side), emitting one segment per divergence
    and a final tail segment for leftover words.
"""

from __future__ import annotations

from handwritten_ocr_tpu_torch.text.metrics import levenshtein, word_levenshtein
from handwritten_ocr_tpu_torch.text.normalize import normalize_text

_LOOKAHEAD = 10


def compare_versions(v1: str, v2: str) -> dict:
    """Character/word-level diff between two transcription candidates."""
    n1 = normalize_text(v1)
    n2 = normalize_text(v2)

    char_dist = levenshtein(n1, n2)
    denom = max(len(n1), len(n2), 1)
    agreement_rate = round((1 - char_dist / denom) * 100, 1)

    w1, w2 = n1.split(), n2.split()

    return {
        "agreement_rate": agreement_rate,
        "char_edit_distance": char_dist,
        "word_edit_distance": word_levenshtein(w1, w2),
        "differing_segments": _differing_segments(w1, w2),
    }


def _resync(w1: list[str], w2: list[str], i: int, j: int) -> tuple[int, int] | None:
    """Search a bounded lookahead for the next sync point.

    Returns the new (i, j) after skipping the divergent run, or None when no
    sync point exists within the window. The v1-side skip is preferred at
    each lookahead depth.
    """
    max_remaining = max(len(w1) - i, len(w2) - j)
    for look in range(1, min(_LOOKAHEAD, max_remaining + 1)):
        if i + look < len(w1) and j < len(w2) and w1[i + look] == w2[j]:
            return i + look, j
        if j + look < len(w2) and i < len(w1) and w2[j + look] == w1[i]:
            return i, j + look
    return None


def _differing_segments(w1: list[str], w2: list[str]) -> list[dict]:
    """Greedy sliding-window word diff."""
    segments: list[dict] = []
    i = j = 0
    while i < len(w1) and j < len(w2):
        if w1[i] == w2[j]:
            i += 1
            j += 1
            continue
        sync = _resync(w1, w2, i, j)
        if sync is None:
            # No nearby sync point: emit the two mismatched words, step past.
            segments.append({
                "position": i,
                "v1_text": w1[i] if i < len(w1) else "",
                "v2_text": w2[j] if j < len(w2) else "",
            })
            i += 1
            j += 1
        else:
            ni, nj = sync
            segments.append({
                "position": i,
                "v1_text": " ".join(w1[i:ni]),
                "v2_text": " ".join(w2[j:nj]),
            })
            i, j = ni, nj

    if i < len(w1) or j < len(w2):
        segments.append({
            "position": i,
            "v1_text": " ".join(w1[i:]),
            "v2_text": " ".join(w2[j:]),
        })

    return segments
