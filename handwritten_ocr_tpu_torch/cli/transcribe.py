#!/usr/bin/env python3
"""CLI entry point of the OCR pipeline on PyTorch (port of
``handwritten_ocr_tpu/cli/transcribe.py``).

Positional image-or-directory input, ``--ground-truth``,
``--ground-truth-dir``, ``--output-dir``, ``--max-iterations``,
``--accept-threshold``; per page it writes ``{stem}_transcription.txt``,
``{stem}_trace.json``, ``{stem}_trace_summary.txt`` and
``{stem}_eval.json``, the same files the JAX package's CLI writes.

  * ``--backend {torch,dryrun}`` — the engine stack: ``torch`` (default)
    loads both models from ``HOCR_OLMOCR_DIR`` / ``HOCR_QWEN3_DIR`` onto
    the CUDA card; ``dryrun`` runs the pipeline without models.
  * ``--skip-existing``  — skip pages whose transcription exists.
  * ``--snapshot``       — per-node state snapshots; resume a crashed page.
  * ``--lockstep``       — folder pages advance together, one batched model
    call per phase.
  * ``--profile DIR``    — a ``torch.profiler`` trace of the run into DIR.
  * ``--quiet``          — silence per-step chatter.

Usage:
    python -m handwritten_ocr_tpu_torch path/to/image.png
    python -m handwritten_ocr_tpu_torch path/to/image.png --ground-truth gt.md
    python -m handwritten_ocr_tpu_torch folder/ --output-dir results/ \\
        --ground-truth-dir gt/
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

IMAGE_EXTENSIONS = {".png", ".jpg", ".jpeg", ".bmp", ".tiff", ".tif", ".webp"}


def build_pipeline(backend: str, quiet: bool = False):
    """Construct the OCRPipeline for the requested backend stack."""
    from handwritten_ocr_tpu_torch.graph.driver import OCRPipeline

    if backend == "torch":
        from handwritten_ocr_tpu_torch.engine.torch_engines import (
            build_torch_pipeline)
        return build_torch_pipeline(quiet=quiet)

    if backend == "dryrun":
        from handwritten_ocr_tpu_torch.engine.dryrun import (
            DryRunOCRBackend, DryRunReasoningBackend)
        return OCRPipeline(DryRunOCRBackend(), DryRunReasoningBackend(),
                           quiet=quiet)

    raise SystemExit(f"unknown backend '{backend}' (expected: torch, dryrun)")


def transcribe_single(
    image_path: Path,
    output_dir: Path,
    pipeline,
    ground_truth_path: Path | None = None,
    max_iterations: int | None = None,
    accept_threshold: int | None = None,
    quiet: bool = False,
    snapshot: bool = False,
) -> Path:
    """Transcribe one image and persist all artifacts; returns txt path."""
    from handwritten_ocr_tpu_torch import config
    from handwritten_ocr_tpu_torch.state import initial_state

    name = image_path.stem
    output_dir.mkdir(parents=True, exist_ok=True)

    if not quiet:
        print(f"\n{'=' * 60}")
        print(f"Processing: {image_path.name}")
        print(f"{'=' * 60}")

    run_config = config.RunConfig(
        accept_threshold=accept_threshold or config.ACCEPT_THRESHOLD,
        max_iterations=max_iterations or config.MAX_ITERATIONS,
    )
    state = initial_state(
        str(image_path),
        config=run_config.as_state_dict(),
        max_iterations=run_config.max_iterations,
        start_time=time.monotonic(),
    )

    snapshot_path = str(output_dir / f"{name}_state.json") if snapshot else None
    final_state = pipeline.run(state, snapshot_path=snapshot_path,
                               resume=snapshot)
    return persist_page(final_state, image_path, output_dir,
                        ground_truth_path, quiet=quiet)


def persist_page(
    final_state,
    image_path: Path,
    output_dir: Path,
    ground_truth_path: Path | None = None,
    quiet: bool = False,
) -> Path:
    """Write the per-page artifacts."""
    from handwritten_ocr_tpu_torch.evaluation import evaluate
    from handwritten_ocr_tpu_torch.text import parse_ground_truth
    from handwritten_ocr_tpu_torch.trace import Trace

    name = image_path.stem
    output_dir.mkdir(parents=True, exist_ok=True)
    trace = Trace.from_events(final_state["trace_events"])

    transcription_path = output_dir / f"{name}_transcription.txt"
    transcription_path.write_text(final_state["current_best"], encoding="utf-8")

    trace.save_json(output_dir / f"{name}_trace.json")
    trace.save_summary(output_dir / f"{name}_trace_summary.txt")

    ground_truth = parse_ground_truth(ground_truth_path) if ground_truth_path else None
    eval_result = evaluate(final_state["current_best"], ground_truth=ground_truth,
                           quiet=quiet)
    eval_result["pipeline_status"] = final_state["status"]
    eval_result["iterations"] = final_state["iteration"]
    eval_result["final_confidence"] = final_state["current_score"]

    eval_path = output_dir / f"{name}_eval.json"
    eval_path.write_text(json.dumps(eval_result, indent=2, ensure_ascii=False),
                         encoding="utf-8")

    if not quiet:
        for p in (transcription_path, output_dir / f"{name}_trace.json",
                  output_dir / f"{name}_trace_summary.txt", eval_path):
            print(f"Saved: {p}")
        print("\n--- Result ---")
        print(f"Status: {final_state['status']}")
        print(f"Iterations: {final_state['iteration']}")
        print(f"Final confidence: {final_state['current_score']}")
        print(f"Transcription length: {len(final_state['current_best'])} chars")
        if ground_truth:
            tier1 = eval_result.get("tier1_raw_vs_gt", {})
            print(f"CER vs GT: {tier1.get('cer', 'N/A')}")
            print(f"WER vs GT: {tier1.get('wer_token', 'N/A')}")

    return transcription_path


def find_ground_truth(gt_dir: Path | None, stem: str) -> Path | None:
    """Match a ground-truth file by stem (md preferred, then txt)."""
    if gt_dir is None:
        return None
    for ext in (".md", ".txt"):
        candidate = gt_dir / f"{stem}{ext}"
        if candidate.exists():
            return candidate
    return None


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="ocr",
        description="Agentic OCR pipeline for handwritten documents "
                    "(PyTorch, CUDA)",
    )
    parser.add_argument("input", type=Path,
                        help="Path to an image file or a directory of images")
    parser.add_argument("--ground-truth", type=Path, default=None,
                        help="Path to ground truth text file (single image mode)")
    parser.add_argument("--ground-truth-dir", type=Path, default=None,
                        help="Directory of ground truth files (batch mode, matched by stem)")
    parser.add_argument("--output-dir", type=Path, default=None,
                        help="Output directory (default: same directory as input)")
    parser.add_argument("--max-iterations", type=int, default=None,
                        help="Maximum iterations for the critique-edit loop")
    parser.add_argument("--accept-threshold", type=int, default=None,
                        help="Critic confidence threshold to auto-accept (0-100)")
    parser.add_argument("--backend", default="torch",
                        choices=["torch", "dryrun"],
                        help="Model engine stack (default: torch, on the CUDA "
                             "card; 'dryrun' is a deterministic model-free "
                             "smoke mode)")
    parser.add_argument("--skip-existing", action="store_true",
                        help="Batch mode: skip pages whose transcription already exists")
    parser.add_argument("--snapshot", action="store_true",
                        help="Write per-node state snapshots and resume "
                             "crashed pages from the last completed node")
    parser.add_argument("--lockstep", action="store_true",
                        help="Batch mode: advance all pages through the "
                             "critique loop in lockstep with batched model "
                             "calls (one decode for all pages at each node)")
    parser.add_argument("--profile", type=Path, default=None, metavar="DIR",
                        help="Capture a torch.profiler trace of the run into DIR")
    parser.add_argument("--quiet", action="store_true",
                        help="Silence per-step console output")
    return parser


def main(argv: list[str] | None = None, pipeline=None) -> None:
    args = build_arg_parser().parse_args(argv)
    input_path: Path = args.input.resolve()

    if not input_path.exists():
        print(f"Error: {input_path} does not exist", file=sys.stderr)
        sys.exit(1)

    if args.output_dir:
        output_dir = args.output_dir.resolve()
    elif input_path.is_dir():
        output_dir = input_path / "results"
    else:
        output_dir = input_path.parent

    if pipeline is None:
        pipeline = build_pipeline(args.backend, quiet=args.quiet)

    profile_ctx = None
    if args.profile is not None:
        profile_ctx = _profiler(args.profile)
        profile_ctx.__enter__()

    try:
        _run(args, input_path, output_dir, pipeline)
    finally:
        if profile_ctx is not None:
            profile_ctx.__exit__(None, None, None)
            print(f"Profiler trace saved to {args.profile}")


def _profiler(directory: Path):
    """A ``torch.profiler`` context writing a Chrome trace into
    ``directory`` (host activity, and the card's where there is one)."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    directory.mkdir(parents=True, exist_ok=True)
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(str(directory)))


def _run(args, input_path: Path, output_dir: Path, pipeline) -> None:
    if input_path.is_file():
        transcribe_single(
            image_path=input_path,
            output_dir=output_dir,
            pipeline=pipeline,
            ground_truth_path=args.ground_truth,
            max_iterations=args.max_iterations,
            accept_threshold=args.accept_threshold,
            quiet=args.quiet,
            snapshot=args.snapshot,
        )
        return

    images = sorted(f for f in input_path.iterdir()
                    if f.suffix.lower() in IMAGE_EXTENSIONS)
    if not images:
        print(f"No image files found in {input_path}", file=sys.stderr)
        sys.exit(1)

    print(f"Found {len(images)} images in {input_path}")

    pending = [p for p in images
               if not (args.skip_existing
                       and (output_dir / f"{p.stem}_transcription.txt").exists())]

    if args.lockstep and len(pending) > 1:
        _run_lockstep(args, pending, output_dir, pipeline)
        print(f"\nAll done. Results saved to {output_dir}")
        return

    # Cross-page batching: run every pending page's initial reads as
    # grid-grouped batched forwards before the per-page loops start.
    if len(pending) > 1 and hasattr(pipeline.ocr, "prime"):
        from handwritten_ocr_tpu_torch import config as cfg_mod
        if not args.quiet:
            print(f"Priming batched initial reads for {len(pending)} pages...")
        pipeline.ocr.prime(
            pipeline.preprocessor, [str(p) for p in pending],
            cfg_mod.PREPROCESSING_STRATEGIES, cfg_mod.OCR_PROMPT,
            cfg_mod.OCR_MAX_NEW_TOKENS)

    owned = set(pending)
    for img_path in images:
        if img_path not in owned:
            if (args.skip_existing
                    and (output_dir / f"{img_path.stem}_transcription.txt")
                    .exists()):
                print(f"Skipping {img_path.name} (transcription exists)")
            continue
        transcribe_single(
            image_path=img_path,
            output_dir=output_dir,
            pipeline=pipeline,
            ground_truth_path=find_ground_truth(args.ground_truth_dir, img_path.stem),
            max_iterations=args.max_iterations,
            accept_threshold=args.accept_threshold,
            quiet=args.quiet,
            snapshot=args.snapshot,
        )

    print(f"\nAll done. Results saved to {output_dir}")


def _run_lockstep(args, pending: list[Path], output_dir: Path, pipeline) -> None:
    """Batch-of-pages lockstep execution with batched model calls."""
    from handwritten_ocr_tpu_torch import config
    from handwritten_ocr_tpu_torch.graph.batch_driver import LockstepPipeline
    from handwritten_ocr_tpu_torch.state import initial_state

    run_config = config.RunConfig(
        accept_threshold=args.accept_threshold or config.ACCEPT_THRESHOLD,
        max_iterations=args.max_iterations or config.MAX_ITERATIONS,
    )
    states = [initial_state(str(p), config=run_config.as_state_dict(),
                            max_iterations=run_config.max_iterations,
                            start_time=time.monotonic()) for p in pending]

    print(f"Lockstep run over {len(pending)} pages...")
    lockstep = LockstepPipeline(pipeline.ocr, pipeline.llm,
                                preprocessor=pipeline.preprocessor,
                                quiet=args.quiet)
    finals = lockstep.run_many(states)
    for img_path, final_state in zip(pending, finals):
        persist_page(final_state, img_path, output_dir,
                     find_ground_truth(args.ground_truth_dir, img_path.stem),
                     quiet=args.quiet)


if __name__ == "__main__":
    main()
