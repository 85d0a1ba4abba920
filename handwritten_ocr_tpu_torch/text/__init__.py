"""Pure text tools: the scoring oracle and merge/diff machinery (copied
from ``handwritten_ocr_tpu/text``; the C++ engine of
:mod:`handwritten_ocr_tpu_torch.native` where it is available, else the
NumPy engines)."""

from handwritten_ocr_tpu_torch.text.diff import compare_versions
from handwritten_ocr_tpu_torch.text.gt import parse_ground_truth
from handwritten_ocr_tpu_torch.text.merge import merge_versions
from handwritten_ocr_tpu_torch.text.metrics import (cer, levenshtein,
                                                    tier1_metrics, wer,
                                                    word_levenshtein)
from handwritten_ocr_tpu_torch.text.normalize import normalize_text

__all__ = [
    "parse_ground_truth",
    "normalize_text",
    "levenshtein",
    "word_levenshtein",
    "cer",
    "wer",
    "tier1_metrics",
    "compare_versions",
    "merge_versions",
]
