"""Fine-tuning data pipeline: (page image, transcription) → TrainBatch
(port of ``handwritten_ocr_tpu/train/data.py``).

The prompt is the production chat template (image + OCR instruction), the
target is the ground-truth transcription followed by ``<|im_end|>``, and
the loss mask covers only the target tokens. Pages are grouped by patch
grid (the bucketing the inference engine uses), so every batch holds
pages of one grid. Batches are built on the host and placed on
``device``: the CUDA card unless the caller names another. A sharded
step takes each rank's rows of a batch (:func:`shard_batch`).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np
import torch

from handwritten_ocr_tpu_torch import config as cfg_mod
from handwritten_ocr_tpu_torch.models.processor import (TextTokenizer,
                                                        load_image_rgb,
                                                        pack_image,
                                                        vlm_chat_prompt)
from handwritten_ocr_tpu_torch.models.qwen25vl.model import (
    rope_index_for_prompt)
from handwritten_ocr_tpu_torch.ops.dispatch import resolve_device
from handwritten_ocr_tpu_torch.parallel.mesh import axis_rank, axis_size
from handwritten_ocr_tpu_torch.text.gt import parse_ground_truth
from handwritten_ocr_tpu_torch.train.step import TrainBatch


@dataclasses.dataclass(frozen=True)
class Example:
    image_path: str
    target_text: str


def discover_examples(image_dir: str | Path,
                      gt_dir: str | Path | None = None) -> list[Example]:
    """Pair images with ground-truth files by stem (the CLI's rules: its
    image extensions, ``.md`` before ``.txt``); an image whose ground
    truth is missing or empty is skipped."""
    from handwritten_ocr_tpu_torch.cli.transcribe import IMAGE_EXTENSIONS

    image_dir = Path(image_dir)
    gt_dir = Path(gt_dir) if gt_dir else image_dir
    examples = []
    for image_path in sorted(image_dir.iterdir()):
        if image_path.suffix.lower() not in IMAGE_EXTENSIONS:
            continue
        for ext in (".md", ".txt"):
            candidate = gt_dir / f"{image_path.stem}{ext}"
            if candidate.exists():
                text = parse_ground_truth(candidate)
                if text:
                    examples.append(Example(str(image_path), text))
                break
    return examples


def build_batch(
    examples: Sequence[Example],
    tokenizer: TextTokenizer,
    vl_config,
    prompt: str = cfg_mod.OCR_PROMPT,
    max_target_tokens: int = cfg_mod.OCR_MAX_NEW_TOKENS,
    min_pixels: int = cfg_mod.OCR_MIN_PIXELS,
    max_pixels: int = cfg_mod.OCR_MAX_PIXELS,
    device: str | torch.device | None = None,
) -> tuple[TrainBatch, tuple[int, int, int]]:
    """One TrainBatch (+ grid) from same-grid examples.

    All examples must resolve to the same patch grid (use
    :func:`batches_by_grid` to bucket); else ValueError. Targets are cut
    at ``max_target_tokens`` and end with EOS; rows are right-padded with
    the pad token, and padded positions carry zero loss.
    """
    device = resolve_device(device)
    packed = [pack_image(load_image_rgb(ex.image_path),
                         min_pixels=min_pixels, max_pixels=max_pixels)
              for ex in examples]
    grids = {p.grid for p in packed}
    if len(grids) != 1:
        raise ValueError(f"examples span multiple grids: {grids}")
    grid = packed[0].grid
    n_image_tokens = packed[0].num_llm_tokens

    rows, masks = [], []
    image_token = vl_config.image_token_id
    for ex in examples:
        prompt_ids: list[int] = []
        for tok in tokenizer.encode(vlm_chat_prompt(prompt,
                                                    num_image_tokens=1)):
            if tok == image_token:
                prompt_ids.extend([image_token] * n_image_tokens)
            else:
                prompt_ids.append(tok)
        target_ids = tokenizer.encode(ex.target_text)[:max_target_tokens]
        target_ids = target_ids + [vl_config.eos_token_id]
        rows.append(prompt_ids + target_ids)
        masks.append([0.0] * len(prompt_ids) + [1.0] * len(target_ids))

    longest = max(len(r) for r in rows)
    input_ids = np.full((len(rows), longest), vl_config.pad_token_id,
                        dtype=np.int64)
    loss_mask = np.zeros((len(rows), longest), dtype=np.float32)
    for i, (row, mask) in enumerate(zip(rows, masks)):
        input_ids[i, :len(row)] = row
        loss_mask[i, :len(row)] = mask

    positions = np.stack([
        rope_index_for_prompt(input_ids[i], vl_config, [grid])[0]
        for i in range(len(rows))
    ], axis=1)                                   # [3, B, T]
    patches = np.stack([p.patches for p in packed])

    def put(array):
        return torch.from_numpy(array).to(device)

    batch = TrainBatch(input_ids=put(input_ids), patches=put(patches),
                       position_ids=put(positions), loss_mask=put(loss_mask))
    return batch, grid


def batches_by_grid(
    examples: Sequence[Example],
    tokenizer: TextTokenizer,
    vl_config,
    batch_size: int,
    **kwargs,
) -> Iterator[tuple[TrainBatch, tuple[int, int, int]]]:
    """Yield (TrainBatch, grid) groups bucketed by patch grid, in order of
    each grid's first example; ``kwargs`` go to :func:`build_batch`."""
    buckets: dict[tuple, list[Example]] = {}
    for ex in examples:
        grid = pack_image(load_image_rgb(ex.image_path),
                          min_pixels=kwargs.get("min_pixels",
                                                cfg_mod.OCR_MIN_PIXELS),
                          max_pixels=kwargs.get("max_pixels",
                                                cfg_mod.OCR_MAX_PIXELS)).grid
        buckets.setdefault(grid, []).append(ex)
    for bucket in buckets.values():
        for start in range(0, len(bucket), batch_size):
            yield build_batch(bucket[start:start + batch_size], tokenizer,
                              vl_config, **kwargs)


def shard_batch(mesh, batch: TrainBatch) -> TrainBatch:
    """This rank's rows of a global batch split over the mesh's "data"
    axis, as JAX places it (``data_sharding(mesh, 2)`` / ``(mesh, 3)``
    for ids, mask and patches, ``data_sharding(mesh, 3, batch_axis=1)``
    for the ``[3, B, T]`` positions); every rank must hold the same
    global batch. The batch must divide by the "data" axis."""
    data, rank = axis_size(mesh, "data"), axis_rank(mesh, "data")
    rows = batch.input_ids.shape[0]
    if rows % data:
        raise ValueError(f"batch {rows} not divisible by data={data}")
    share = rows // data

    def mine(tensor: torch.Tensor, axis: int = 0) -> torch.Tensor:
        return tensor.narrow(axis, rank * share, share).contiguous()

    return TrainBatch(input_ids=mine(batch.input_ids),
                      patches=mine(batch.patches),
                      position_ids=mine(batch.position_ids, 1),
                      loss_mask=mine(batch.loss_mask))
