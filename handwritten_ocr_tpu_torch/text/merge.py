"""Majority-vote merge of transcription candidates (copied from
``handwritten_ocr_tpu/text/merge.py``).

Contract: the longest normalized candidate is
the backbone; every candidate is LCS-aligned to it (case-insensitive token
match; on ties during backtracking the backbone pointer moves first, i.e.
``dp[i-1][j] >= dp[i][j-1]`` prefers stepping i). Each backbone position
takes a majority vote over aligned words; vote ties keep every unique
variant, in first-seen order, as a ``[v1|v2]`` marker for the editor.

Engine: the LCS table is built row-wise with vectorized NumPy using
    row[j] = max(cand[j], row[j-1])  ⇔  row = accumulate_max(cand)
where cand[j] = max(prev[j], prev[j-1] + eq[j]); an O(n·m) Python DP is
replaced by O(n) SIMD row updates. Backtracking walks the stored rows.
The C++ engine (:mod:`handwritten_ocr_tpu_torch.native`) builds the table
and backtracks in its place where it is available, with the same result.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional, Sequence

import numpy as np

from handwritten_ocr_tpu_torch import native
from handwritten_ocr_tpu_torch.text.normalize import normalize_text


def merge_versions(versions: Sequence[str]) -> str:
    """Word-level majority-vote merge; ties become ``[a|b]`` variant markers."""
    if not versions:
        return ""
    if len(versions) == 1:
        return versions[0]

    word_lists = [normalize_text(v).split() for v in versions]
    backbone = max(word_lists, key=len)
    aligned = [align_to_backbone(backbone, wl) for wl in word_lists]

    merged: list[str] = []
    for pos, backbone_word in enumerate(backbone):
        votes = [al[pos] for al in aligned if pos < len(al) and al[pos] is not None]
        if not votes:
            merged.append(backbone_word)
            continue
        counts = Counter(votes)
        top = max(counts.values())
        leaders = [w for w, c in counts.items() if c == top]
        if len(leaders) == 1:
            merged.append(leaders[0])
        else:
            uniq = list(dict.fromkeys(votes))
            merged.append(uniq[0] if len(uniq) == 1 else "[" + "|".join(uniq) + "]")
    return " ".join(merged)


def _lcs_rows(a_codes: np.ndarray, b_codes: np.ndarray) -> np.ndarray:
    """Full (n+1, m+1) LCS length table, built with vectorized row updates."""
    n, m = len(a_codes), len(b_codes)
    table = np.zeros((n + 1, m + 1), dtype=np.int32)
    if n == 0 or m == 0:
        return table
    for i in range(1, n + 1):
        prev = table[i - 1]
        cand = np.maximum(prev[1:], prev[:-1] + (a_codes[i - 1] == b_codes))
        table[i, 1:] = np.maximum.accumulate(cand)
    return table


def align_to_backbone(backbone: Sequence[str], words: Sequence[str]) -> list[Optional[str]]:
    """LCS-align ``words`` to ``backbone`` (case-insensitive).

    Returns a list of len(backbone): the matched word at each aligned
    position, None at gaps. Tie-break during backtracking: prefer
    decrementing the backbone index.
    """
    # Shared lowercase vocabulary so equality is an integer compare.
    vocab: dict[str, int] = {}
    def enc(tokens: Sequence[str]) -> np.ndarray:
        out = np.empty(len(tokens), dtype=np.int64)
        for k, t in enumerate(tokens):
            out[k] = vocab.setdefault(t.lower(), len(vocab))
        return out

    a = enc(backbone)
    b = enc(words)

    if native.available():
        idx = native.lcs_align(a, b)
        return [words[j] if j >= 0 else None for j in idx]

    table = _lcs_rows(a, b)
    aligned: list[Optional[str]] = [None] * len(backbone)
    i, j = len(backbone), len(words)
    while i > 0 and j > 0:
        if a[i - 1] == b[j - 1]:
            aligned[i - 1] = words[j - 1]
            i -= 1
            j -= 1
        elif table[i - 1, j] >= table[i, j - 1]:
            i -= 1
        else:
            j -= 1
    return aligned
