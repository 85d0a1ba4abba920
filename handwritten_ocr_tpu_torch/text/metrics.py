"""Edit-distance metrics: Levenshtein, CER, WER, tier-1 metric bundle
(copied from ``handwritten_ocr_tpu/text/metrics.py``).

Numeric contract:
  * ``levenshtein`` — unit-cost character edit distance.
  * ``cer``  = char_edits(norm(gt), norm(ocr)) / max(len(norm(gt)), 1)
  * ``wer``  (token) = word_edits / max(n_gt_words, 1)
  * ``tier1_metrics`` also reports a character-level WER computed on the
    space-rejoined word sequences, exact-match, and char counts; cer/wer
    values are rounded to 4 decimals.

Engine: rows are advanced with vectorized NumPy using the prefix-min
identity
    new[j] = min(cand[j], new[j-1] + 1)
        ⇔  new = accumulate_min(cand - arange) + arange
so each DP row is a handful of SIMD ops. The C++ row engine
(:mod:`handwritten_ocr_tpu_torch.native`, built at first use) runs in its
place where it is available; both return the same integers.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from handwritten_ocr_tpu_torch import native
from handwritten_ocr_tpu_torch.text.normalize import normalize_text


def _codes_from_str(s: str) -> np.ndarray:
    """Unicode codepoints of ``s`` as a uint32 vector (O(n), no Python loop)."""
    if not s:
        return np.empty(0, dtype=np.uint32)
    return np.frombuffer(s.encode("utf-32-le"), dtype=np.uint32)


def _codes_from_tokens(a: Sequence[str], b: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
    """Map two token sequences into a shared integer vocabulary."""
    vocab: dict[str, int] = {}
    def encode(tokens: Sequence[str]) -> np.ndarray:
        out = np.empty(len(tokens), dtype=np.uint32)
        for i, t in enumerate(tokens):
            out[i] = vocab.setdefault(t, len(vocab))
        return out
    return encode(a), encode(b)


def edit_distance_ids(a: np.ndarray, b: np.ndarray) -> int:
    """Unit-cost edit distance between two integer sequences."""
    n, m = len(a), len(b)
    if n == 0:
        return m
    if m == 0:
        return n
    if native.available():
        return native.edit_distance_u32(a, b)
    if m > n:  # iterate over the longer side so rows are wide (better SIMD)
        a, b, n, m = b, a, m, n
    row = np.arange(m + 1, dtype=np.int64)
    offs = np.arange(1, m + 1, dtype=np.int64)
    full = np.arange(m + 1, dtype=np.int64)
    for i in range(n):
        cand = np.minimum(row[:-1] + (a[i] != b), row[1:] + 1)
        shifted = np.minimum.accumulate(np.concatenate(([np.int64(i + 1)], cand - offs)))
        row = shifted + full
    return int(row[m])


def levenshtein(a: str, b: str) -> int:
    """Character-level edit distance."""
    return edit_distance_ids(_codes_from_str(a), _codes_from_str(b))


def word_levenshtein(a: Sequence[str], b: Sequence[str]) -> int:
    """Word-token edit distance."""
    ca, cb = _codes_from_tokens(a, b)
    return edit_distance_ids(ca, cb)


def cer(ground_truth: str, ocr_output: str, lower: bool = False) -> float:
    """Character error rate: edits / max(len(normalized gt), 1)."""
    gt = normalize_text(ground_truth, lower)
    hyp = normalize_text(ocr_output, lower)
    return levenshtein(gt, hyp) / max(len(gt), 1)


def wer(ground_truth: str, ocr_output: str, lower: bool = False) -> float:
    """Token-level word error rate: word edits / max(gt word count, 1)."""
    gt = normalize_text(ground_truth, lower)
    hyp = normalize_text(ocr_output, lower)
    gt_words, hyp_words = gt.split(), hyp.split()
    return word_levenshtein(gt_words, hyp_words) / max(len(gt_words), 1)


def tier1_metrics(ground_truth: str, ocr_output: str, lower: bool = False) -> dict:
    """CER / WER / exact-match bundle.

    ``wer`` here is the *character*-level distance between the space-rejoined
    word sequences divided by the rejoined gt length (the original
    pipeline's definition); ``wer_token`` is the standard token WER.
    """
    gt = normalize_text(ground_truth, lower)
    hyp = normalize_text(ocr_output, lower)

    cer_val = levenshtein(gt, hyp) / max(len(gt), 1)
    gt_words, hyp_words = gt.split(), hyp.split()
    gt_joined, hyp_joined = " ".join(gt_words), " ".join(hyp_words)
    wer_char = levenshtein(gt_joined, hyp_joined) / max(len(gt_joined), 1)
    wer_tok = word_levenshtein(gt_words, hyp_words) / max(len(gt_words), 1)

    return {
        "input": ocr_output,
        "cer": round(cer_val, 4),
        "wer": round(wer_char, 4),
        "wer_token": round(wer_tok, 4),
        "exact_match": gt == hyp,
        "gt_chars": len(gt),
        "ocr_chars": len(hyp),
    }
