"""Final evaluation wrapper (copied from ``handwritten_ocr_tpu/evaluation.py``).

Contract (reference tools.py:305-320): when ground truth is present, the
tier-1 metric bundle is reported under the key ``tier1_raw_vs_gt``.
"""

from __future__ import annotations

from handwritten_ocr_tpu_torch.text.metrics import tier1_metrics


def evaluate(
    transcription: str,
    ground_truth: str | None = None,
    lower: bool = False,
    quiet: bool = False,
) -> dict:
    """Compute hard metrics (CER/WER) against ground truth when available."""
    result: dict = {}
    if ground_truth is not None:
        if not quiet:
            print("  [eval] Computing CER/WER against ground truth...")
        result["tier1_raw_vs_gt"] = tier1_metrics(ground_truth, transcription, lower)
    return result
