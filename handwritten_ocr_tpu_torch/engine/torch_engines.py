"""PyTorch engines: the preprocessor and the batched OCR backend.

Port of ``TPUPreprocessor`` and the paged read path of ``JaxOCRBackend``
(``handwritten_ocr_tpu/engine/jax_engines.py``). The model stays resident
on the device; the strategies of one page share one batched vision +
prefill + decode (every transform keeps the page geometry, so they share
a grid).

Both entry points run on the first CUDA card unless the caller passes
``device``; without a card and without a device they raise.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from handwritten_ocr_tpu_torch import config as cfg_mod
from handwritten_ocr_tpu_torch.engine.protocols import PreparedImage
from handwritten_ocr_tpu_torch.models.processor import (TextTokenizer,
                                                        aligned_smart_size,
                                                        load_image_rgb,
                                                        pack_image_device,
                                                        resize_bicubic,
                                                        vlm_chat_prompt)
from handwritten_ocr_tpu_torch.ops.dispatch import resolve_device


def strategy_label(strategy: str | Sequence[str]) -> str:
    """Human-readable label: chain elements joined with '+'."""
    if isinstance(strategy, str):
        return strategy
    return "+".join(strategy)


class TorchPreprocessor:
    """Runs strategy chains on the device.

    The page is resized to its smart-resize target at load time (host PIL
    bicubic, as the HF processor does), so the transform chain, patch
    packing and vision encode all see 28-aligned shapes. An in-memory
    uint8 page that is already at its target size needs no PIL.
    """

    def __init__(self, min_pixels: int = cfg_mod.OCR_MIN_PIXELS,
                 max_pixels: int = cfg_mod.OCR_MAX_PIXELS,
                 device: str | torch.device | None = None):
        self.min_pixels = min_pixels
        self.max_pixels = max_pixels
        self.device = resolve_device(device)
        self._cache: dict[str, torch.Tensor] = {}

    def _load_aligned(self, image) -> torch.Tensor:
        key = image if isinstance(image, str) else None
        if key is not None and key in self._cache:
            return self._cache[key]
        pixels = load_image_rgb(image) if key is not None else np.asarray(image)
        target = aligned_smart_size(pixels.shape[0], pixels.shape[1],
                                    min_pixels=self.min_pixels,
                                    max_pixels=self.max_pixels)
        if target != pixels.shape[:2]:
            pixels = resize_bicubic(pixels, target)
        tensor = torch.as_tensor(np.array(pixels, dtype=np.uint8),
                                 device=self.device)
        if key is not None:
            self._cache = {key: tensor}           # one page at a time
        return tensor

    def apply(self, image, strategy) -> PreparedImage:
        """``image``: a file path or a uint8 [H, W(, 3)] array."""
        from handwritten_ocr_tpu_torch.ops.bank import preprocess_chain
        processed = preprocess_chain(self._load_aligned(image), strategy)
        return PreparedImage(data=processed,
                             strategy_label=strategy_label(strategy),
                             source_path=image if isinstance(image, str)
                             else "<array>")


class TorchOCRBackend:
    """Batched VLM OCR over preprocessed device images, decoded through
    the continuous batcher over the paged KV cache.

    ``stats`` accumulates host-clock seconds of the vision tower (with a
    device sync at its end), and the batcher's prefill and decode seconds.
    """

    def __init__(self, model, tokenizer: TextTokenizer,
                 device: str | torch.device | None = None,
                 min_pixels: int = cfg_mod.OCR_MIN_PIXELS,
                 max_pixels: int = cfg_mod.OCR_MAX_PIXELS):
        self.device = resolve_device(device)
        # fp32 products and convolutions in full fp32 on the card: TF32
        # would keep about three decimal digits and drift from the
        # reference.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model = model
        self.tokenizer = tokenizer
        self.min_pixels = min_pixels
        self.max_pixels = max_pixels
        self._batcher = None
        self.stats = {"vision_s": 0.0}

    def _ensure_batcher(self, needed_context: int):
        """(Re)build the batcher when the context bound grows; the bound
        rounds up to a power of two (floor 512)."""
        from handwritten_ocr_tpu_torch.engine.serving import (
            ContinuousBatcher, PagedProgram)
        context = 512
        while context < needed_context:
            context *= 2
        if self._batcher is None or self._batcher.max_context < context:
            config = self.model.config
            text = self.model.params["text"]
            program = PagedProgram(text, config.text,
                                   eos_token_id=config.eos_token_id)
            self._batcher = ContinuousBatcher(
                program, n_slots=cfg_mod.SERVE_SLOTS,
                block_size=cfg_mod.SERVE_BLOCK_SIZE, max_context=context,
                chunk=cfg_mod.SERVE_CHUNK,
                throughput_chunk=cfg_mod.SERVE_THROUGHPUT_CHUNK,
                prefill_bucket=cfg_mod.SERVE_PREFILL_BUCKET,
                dtype=text["embed"]["w"].dtype, device=self.device)
        return self._batcher

    def _prompt_ids(self, prompt: str, n_image_tokens: int) -> np.ndarray:
        image_token = self.model.config.image_token_id
        # Tokenize with one placeholder, then expand to the real count.
        ids = self.tokenizer.encode(vlm_chat_prompt(prompt, num_image_tokens=1))
        out: list[int] = []
        for tok in ids:
            out.extend([image_token] * n_image_tokens if tok == image_token
                       else [tok])
        return np.array(out, dtype=np.int32)

    def _pack_one(self, data):
        """(patches, grid) of one aligned device image."""
        if not (isinstance(data, torch.Tensor) and data.dim() in (2, 3)
                and data.shape[0] % 28 == 0 and data.shape[1] % 28 == 0):
            raise ValueError("the torch backend reads 28-aligned uint8 device "
                             "images (TorchPreprocessor output)")
        return pack_image_device(data.to(self.device))

    def _grid_groups(self, images: Sequence):
        """Pack images and group identical grids (all strategies of one
        page share a grid; mixed-page batches fall into grid groups)."""
        packed = [self._pack_one(getattr(img, "data", img)) for img in images]
        order = sorted(range(len(packed)), key=lambda i: packed[i][1])
        start = 0
        while start < len(order):
            end = start
            grid = packed[order[start]][1]
            while end < len(order) and packed[order[end]][1] == grid:
                end += 1
            group = order[start:end]
            yield group, grid, torch.stack([packed[i][0] for i in group])
            start = end

    def read_batch(self, images: Sequence, prompt: str,
                   max_new_tokens: int) -> list[str]:
        """Vision encode + splice per grid group, then all pages decode
        together through the continuous batcher."""
        from handwritten_ocr_tpu_torch.engine.serving import GenRequest
        from handwritten_ocr_tpu_torch.models.qwen25vl.model import (
            rope_index_for_prompt)

        requests: list[GenRequest | None] = [None] * len(images)
        longest = 0
        for group, grid, patches in self._grid_groups(images):
            t0 = time.perf_counter()
            n_llm_tokens = grid[0] * grid[1] * grid[2] // 4
            ids_row = self._prompt_ids(prompt, n_llm_tokens)
            positions, delta = rope_index_for_prompt(
                ids_row, self.model.config, [grid])
            input_ids = torch.as_tensor(np.tile(ids_row, (len(group), 1)),
                                        dtype=torch.long, device=self.device)
            embeds = self.model.prompt_embeds(input_ids, patches, grid)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.stats["vision_s"] += time.perf_counter() - t0
            longest = max(longest, len(ids_row))
            for row, img_idx in enumerate(group):
                requests[img_idx] = GenRequest(
                    prompt_ids=ids_row, max_new=max_new_tokens,
                    positions=positions, rope_delta=delta, embeds=embeds[row])
        batcher = self._ensure_batcher(longest + max_new_tokens)
        token_lists = batcher.run(requests)  # type: ignore[arg-type]
        return [self.tokenizer.decode(tokens) for tokens in token_lists]

    def read(self, image, prompt: str, max_new_tokens: int) -> str:
        return self.read_batch([image], prompt, max_new_tokens)[0]

    def release(self) -> None:
        """No-op: the model stays resident on the device."""
