#!/usr/bin/env python3
"""Convert an HF snapshot into the port's native checkpoint (port of
``scripts/convert_checkpoint.py``).

Reads the snapshot's ``*.safetensors`` once, casts to ``--dtype`` and,
with ``--quantize int8``, quantises every projection layer by layer
(``models/quant.py``), then writes ``params.pt`` and ``meta.json``
(``models/checkpoint.py``) with the snapshot's config and tokenizer
files beside them. ``from_pretrained`` on either engine then loads the
directory without converting. The cast and the quantisation run on the
CUDA card unless ``--device`` names another device (``--device cpu``
converts on the host); without a card and without ``--device`` it
raises.

Usage:
    python -m handwritten_ocr_tpu_torch.cli.convert vl /path/to/olmOCR-snapshot out_dir
    python -m handwritten_ocr_tpu_torch.cli.convert qwen3 /path/to/qwen3-snapshot out_dir --quantize int8
    python -m handwritten_ocr_tpu_torch.cli.convert qwen3 src out_dir --device cpu
"""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

# Carried beside the checkpoint so the directory is self-contained.
SNAPSHOT_FILES = ("config.json", "tokenizer.json", "tokenizer_config.json",
                  "vocab.json", "merges.txt", "special_tokens_map.json",
                  "generation_config.json", "preprocessor_config.json")


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("family", choices=["vl", "qwen3"])
    parser.add_argument("src", type=Path, help="HF snapshot directory")
    parser.add_argument("dst", type=Path, help="output checkpoint directory")
    parser.add_argument("--quantize", choices=["int8"], default=None)
    parser.add_argument("--dtype", choices=["bfloat16", "float32"],
                        default="bfloat16")
    parser.add_argument("--device", default=None,
                        help="where to cast and quantise (default: the "
                             "CUDA card; 'cpu' for the host)")
    return parser


def main(argv: list[str] | None = None) -> None:
    args = build_arg_parser().parse_args(argv)

    import torch

    from handwritten_ocr_tpu_torch.models.checkpoint import save_checkpoint
    from handwritten_ocr_tpu_torch.models.quant import quantized_bytes
    from handwritten_ocr_tpu_torch.ops.dispatch import resolve_device

    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    hf_config = json.loads((args.src / "config.json").read_text())
    if args.family == "vl":
        from handwritten_ocr_tpu_torch.models.qwen25vl.config import VLConfig
        from handwritten_ocr_tpu_torch.models.weights import convert_vl
        params = convert_vl(args.src, VLConfig.from_hf(hf_config), dtype=dtype,
                            device=device, quantize=args.quantize)
    else:
        from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Config
        from handwritten_ocr_tpu_torch.models.weights import convert_qwen3
        params = convert_qwen3(args.src, Qwen3Config.from_hf(hf_config),
                               dtype=dtype, device=device,
                               quantize=args.quantize)

    meta = {
        "family": args.family,
        "hf_config": hf_config,
        "dtype": args.dtype,
        "quantize": args.quantize,
        "source": str(args.src),
    }
    save_checkpoint(args.dst, params, meta)
    for name in SNAPSHOT_FILES:
        src_file = args.src / name
        if src_file.exists():
            shutil.copy(src_file, args.dst / name)
    print(f"Saved {args.family} checkpoint to {args.dst} "
          f"({quantized_bytes(params) / 1e9:.2f} GB)")


if __name__ == "__main__":
    main()
