#!/usr/bin/env python3
"""Standalone transcription-quality evaluation CLI (copied from
``handwritten_ocr_tpu/cli/eval_final.py``).

Contract (reference eval_final.py:1-138): evaluate one transcription file or
a directory (``*_transcription.txt`` preferred, ``*.txt`` fallback) against
ground truth, printing per-file CER/WER and a batch average summary; the
``_transcription`` suffix is stripped when matching ground-truth stems.

Usage:
    python -m handwritten_ocr_tpu_torch.cli.eval_final out/x_transcription.txt --ground-truth gt.md
    python -m handwritten_ocr_tpu_torch.cli.eval_final results/ --ground-truth-dir gt/
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from handwritten_ocr_tpu_torch.evaluation import evaluate
from handwritten_ocr_tpu_torch.text import parse_ground_truth


def eval_single(transcription_path: Path, ground_truth_path: Path | None = None) -> dict:
    """Evaluate one transcription file."""
    transcription = transcription_path.read_text(encoding="utf-8")
    ground_truth = parse_ground_truth(ground_truth_path) if ground_truth_path else None
    result = evaluate(transcription, ground_truth=ground_truth)
    result["file"] = str(transcription_path)
    return result


def print_eval(result: dict, name: str) -> None:
    """Human-readable evaluation summary (reference eval_final.py:33-45)."""
    print(f"\n{'=' * 60}")
    print(f"Evaluation: {name}")
    print(f"{'=' * 60}")
    if "tier1_raw_vs_gt" in result:
        tier1 = result["tier1_raw_vs_gt"]
        print("\n  Raw vs Ground Truth:")
        print(f"    CER:       {tier1['cer']:.2%}")
        print(f"    WER (tok): {tier1['wer_token']:.2%}")
        print(f"    Exact:     {tier1['exact_match']}")
        print(f"    GT chars:  {tier1['gt_chars']}  |  OCR chars: {tier1['ocr_chars']}")


def match_ground_truth(gt_dir: Path, txt_path: Path) -> Path | None:
    """Stem-match a GT file, stripping the ``_transcription`` suffix."""
    stem = txt_path.stem
    if stem.endswith("_transcription"):
        stem = stem[: -len("_transcription")]
    for ext in (".md", ".txt"):
        candidate = gt_dir / f"{stem}{ext}"
        if candidate.exists():
            return candidate
    return None


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="Evaluate OCR transcription quality")
    parser.add_argument("input", type=Path,
                        help="Path to a transcription .txt file or directory of them")
    parser.add_argument("--ground-truth", type=Path, default=None,
                        help="Path to ground truth text file (single file mode)")
    parser.add_argument("--ground-truth-dir", type=Path, default=None,
                        help="Directory of ground truth files (batch mode)")
    parser.add_argument("--output", type=Path, default=None,
                        help="Path to save evaluation JSON (default: print to stdout)")
    args = parser.parse_args(argv)
    input_path: Path = args.input.resolve()

    if not input_path.exists():
        print(f"Error: {input_path} does not exist", file=sys.stderr)
        sys.exit(1)

    if input_path.is_file():
        result = eval_single(input_path, args.ground_truth)
        print_eval(result, input_path.name)
        if args.output:
            args.output.write_text(json.dumps(result, indent=2, ensure_ascii=False),
                                   encoding="utf-8")
            print(f"\nSaved: {args.output}")
        return

    txt_files = sorted(input_path.glob("*_transcription.txt"))
    if not txt_files:
        txt_files = sorted(input_path.glob("*.txt"))
    if not txt_files:
        print(f"No .txt files found in {input_path}", file=sys.stderr)
        sys.exit(1)

    print(f"Evaluating {len(txt_files)} files from {input_path}")
    all_results = []
    for txt_path in txt_files:
        gt_path = match_ground_truth(args.ground_truth_dir, txt_path) \
            if args.ground_truth_dir else None
        result = eval_single(txt_path, gt_path)
        print_eval(result, txt_path.name)
        all_results.append(result)

    scored = [r for r in all_results if "tier1_raw_vs_gt" in r]
    if scored:
        avg_cer = sum(r["tier1_raw_vs_gt"]["cer"] for r in scored) / len(scored)
        avg_wer = sum(r["tier1_raw_vs_gt"]["wer_token"] for r in scored) / len(scored)
        print(f"\n{'=' * 60}")
        print(f"Batch Summary ({len(scored)} files with GT)")
        print(f"  Avg CER: {avg_cer:.2%}")
        print(f"  Avg WER: {avg_wer:.2%}")

    if args.output:
        args.output.write_text(json.dumps(all_results, indent=2, ensure_ascii=False),
                               encoding="utf-8")
        print(f"\nSaved: {args.output}")


if __name__ == "__main__":
    main()
