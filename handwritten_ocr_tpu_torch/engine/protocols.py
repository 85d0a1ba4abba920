"""Backend protocols (copied from ``handwritten_ocr_tpu/engine/protocols.py``)
and the strategy label every prepared image carries."""

from __future__ import annotations

import dataclasses
from typing import Any, Protocol, Sequence, runtime_checkable


def strategy_label(strategy: str | Sequence[str]) -> str:
    """Human-readable label: chain elements joined with '+'."""
    if isinstance(strategy, str):
        return strategy
    return "+".join(strategy)


@dataclasses.dataclass
class PreparedImage:
    """A preprocessed page ready for the OCR engine.

    ``data`` is backend-defined: a device tensor for the torch engine.
    """

    data: Any
    strategy_label: str
    source_path: str


@runtime_checkable
class Preprocessor(Protocol):
    """Applies a preprocessing strategy chain to a page image."""

    def apply(self, image_path: str, strategy: str | Sequence[str]) -> PreparedImage:
        """Run the transform chain; returns the prepared image."""
        ...


@runtime_checkable
class OCRBackend(Protocol):
    """A vision-language OCR engine. The batched call is primary (several
    variants of a page, or pages of a folder, run as one batch); the single
    read is the B=1 case."""

    def read_batch(self, images: Sequence, prompt: str, max_new_tokens: int) -> list[str]:
        """OCR every image; returns one transcription per image."""
        ...

    def read(self, image, prompt: str, max_new_tokens: int) -> str:
        """OCR a single image (B=1 convenience wrapper)."""
        ...

    def release(self) -> None:
        """Free engine memory (a no-op where the model stays resident)."""
        ...
