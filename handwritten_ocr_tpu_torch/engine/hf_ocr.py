"""HF transformers OCR backend and the file preprocessor, the parity mode
(port of ``handwritten_ocr_tpu/engine/hf_ocr.py``).

``HFTorchOCRBackend`` runs olmOCR-2 through transformers: a lazy, cached
model load with the processor's min / max pixel budgets, chat-template
inference, decode of only the new tokens, and a ``release`` that frees
the model. ``FilePreprocessor`` runs the strategy chains of
``ops/bank.py`` and writes each result to an ``ocr_<label>_*`` temp file,
since a path-based backend takes files. ``cli/transcribe.py``'s
``--backend ollama`` pairs them with ``engine/ollama_client.py``.

Both run on the CUDA card unless the caller passes ``device``; without a
card and without a device they raise at construction (the JAX package
picks mps, then cuda, then the CPU). transformers is imported at the
first read, not at import; where it is missing that read raises an
ImportError that names it. The model is read on the host and moved to
the device, where JAX's passes ``device_map``, which would also need
the accelerate package.
"""

from __future__ import annotations

import gc
import importlib
import tempfile
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from handwritten_ocr_tpu_torch import config
from handwritten_ocr_tpu_torch.engine.protocols import (PreparedImage,
                                                        strategy_label)
from handwritten_ocr_tpu_torch.ops.dispatch import resolve_device


def _transformers():
    try:
        return importlib.import_module("transformers")
    except ImportError:
        raise ImportError("HFTorchOCRBackend needs the transformers package, "
                          "which is not installed") from None


class HFTorchOCRBackend:
    """olmOCR-2 via HF transformers + torch, on ``device``."""

    def __init__(self, model_id: str = config.OLMOCR_MODEL,
                 min_pixels: int = config.OCR_MIN_PIXELS,
                 max_pixels: int = config.OCR_MAX_PIXELS,
                 device: str | torch.device | None = None):
        self.model_id = model_id
        self.min_pixels = min_pixels
        self.max_pixels = max_pixels
        self.device = resolve_device(device)
        self._model = None
        self._processor = None

    def _load(self):
        if self._model is not None:
            return self._model, self._processor
        transformers = _transformers()
        print(f"  [ocr] Loading {self.model_id} on {self.device}...")
        self._processor = transformers.AutoProcessor.from_pretrained(
            self.model_id, min_pixels=self.min_pixels,
            max_pixels=self.max_pixels)
        # loaded on the host, then moved: transformers' ``device_map``
        # (JAX's way) needs the accelerate package besides
        self._model = transformers.AutoModelForImageTextToText.from_pretrained(
            self.model_id, torch_dtype=torch.bfloat16).to(self.device)
        return self._model, self._processor

    def read(self, image, prompt: str, max_new_tokens: int) -> str:
        image_path = getattr(image, "data", image)
        model, processor = self._load()
        messages = [{
            "role": "user",
            "content": [
                {"type": "image", "url": str(image_path)},
                {"type": "text", "text": prompt},
            ],
        }]
        inputs = processor.apply_chat_template(
            messages, add_generation_prompt=True, tokenize=True,
            return_dict=True, return_tensors="pt").to(self.device)
        with torch.no_grad():
            output = model.generate(**inputs, max_new_tokens=max_new_tokens)
        return processor.decode(
            output[0][inputs["input_ids"].shape[-1]:], skip_special_tokens=True)

    def read_batch(self, images: Sequence, prompt: str,
                   max_new_tokens: int) -> list[str]:
        return [self.read(img, prompt, max_new_tokens) for img in images]

    def release(self) -> None:
        """Free the model's memory."""
        if self._model is None:
            return
        self._model = None
        self._processor = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        print("  [ocr] Model unloaded, memory freed.")


def save_image(path: str | Path, pixels) -> None:
    """Write uint8 ``[H, W]`` or ``[H, W, 3]`` pixels to ``path`` in the
    format its suffix names: PNG through the port's own writer
    (``models/png.py``), any other format through PIL, which must then be
    installed."""
    if Path(path).suffix.lower() == ".png":
        from handwritten_ocr_tpu_torch.models.png import write_png
        write_png(path, pixels)
        return
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(f"{path}: not a PNG file, and PIL, which writes the "
                         "other formats, is not installed; only PNG pages "
                         "are written without PIL") from None
    Image.fromarray(pixels).save(path)


class FilePreprocessor:
    """Strategy chains to temp files for path-based backends.

    Runs the transform bank of ``ops/bank.py`` on ``device`` over the page
    at its own size and writes the result as an ``ocr_<label>_*`` temp
    file with the source's suffix; ``"original"`` and the empty chain pass
    the source path through."""

    def __init__(self, device: str | torch.device | None = None):
        self.device = resolve_device(device)

    def apply(self, image_path: str, strategy) -> PreparedImage:
        from handwritten_ocr_tpu_torch.models.processor import load_image_rgb
        from handwritten_ocr_tpu_torch.ops.bank import preprocess_chain

        label = strategy_label(strategy)
        steps = [strategy] if isinstance(strategy, str) else list(strategy)
        if steps in ([], ["original"]):
            return PreparedImage(data=image_path, strategy_label=label,
                                 source_path=image_path)
        pixels = torch.as_tensor(np.array(load_image_rgb(image_path)),
                                 device=self.device)
        processed = preprocess_chain(pixels, strategy).cpu().numpy()
        suffix = Path(image_path).suffix or ".png"
        with tempfile.NamedTemporaryFile(suffix=suffix, delete=False,
                                         prefix=f"ocr_{label}_") as tmp:
            path = tmp.name
        save_image(path, processed)
        return PreparedImage(data=path, strategy_label=label,
                             source_path=image_path)
