"""Cross-page read batching for folder workloads (copied from
``handwritten_ocr_tpu/engine/prefetch.py``).

A folder is processed page by page, each page running its own OCR reads.
The initial reads of MANY pages can share batched forwards instead:
:class:`PrimedOCRBackend` wraps any OCR backend, runs the initial-strategy
reads of a whole page group up front (grid-grouped batches through the
inner ``read_batch``), and serves the cached transcriptions when the
per-page pipeline loop asks for them. Re-OCR passes (page-specific
strategies chosen by the critic) fall through to the inner backend.
"""

from __future__ import annotations

from typing import Sequence

from handwritten_ocr_tpu_torch.engine.protocols import (PreparedImage,
                                                        Preprocessor,
                                                        strategy_label)


class PrimedOCRBackend:
    """OCR backend wrapper with a primed (page, strategy) read cache."""

    def __init__(self, inner):
        self.inner = inner
        self._cache: dict[tuple[str, str], str] = {}

    def prime(
        self,
        preprocessor: Preprocessor,
        image_paths: Sequence[str],
        strategies: Sequence,
        prompt: str,
        max_new_tokens: int,
        reads_per_page: int = 2,
    ) -> None:
        """Batch the first ``reads_per_page`` strategy reads of every page."""
        prepared: list[PreparedImage] = []
        for path in image_paths:
            seen: set[str] = set()
            for strategy in strategies:
                label = strategy_label(strategy)
                if label in seen:
                    continue
                seen.add(label)
                prepared.append(preprocessor.apply(str(path), strategy))
                if len(seen) >= reads_per_page:
                    break
        if not prepared:
            return
        texts = self.inner.read_batch(prepared, prompt, max_new_tokens)
        for image, text in zip(prepared, texts):
            self._cache[(image.source_path, image.strategy_label)] = text

    # ── OCRBackend protocol ───────────────────────────────────────
    def read_batch(self, images: Sequence, prompt: str,
                   max_new_tokens: int) -> list[str]:
        results: list[str | None] = [None] * len(images)
        misses, miss_idx = [], []
        for idx, image in enumerate(images):
            key = (getattr(image, "source_path", None),
                   getattr(image, "strategy_label", None))
            hit = self._cache.pop(key, None) if key[0] is not None else None
            if hit is not None:
                results[idx] = hit
            else:
                misses.append(image)
                miss_idx.append(idx)
        if misses:
            for idx, text in zip(miss_idx,
                                 self.inner.read_batch(misses, prompt,
                                                       max_new_tokens)):
                results[idx] = text
        return results  # type: ignore[return-value]

    def read(self, image, prompt: str, max_new_tokens: int) -> str:
        return self.read_batch([image], prompt, max_new_tokens)[0]

    def release(self) -> None:
        self.inner.release()
