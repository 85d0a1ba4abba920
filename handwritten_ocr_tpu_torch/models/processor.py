"""VLM input processing: smart resize, patch packing, chat template.

Port of the parts of ``handwritten_ocr_tpu/models/processor.py`` the read
and reasoning paths use. It replicates the Qwen2-VL processor contract (the olmOCR-2
processor): dimensions rounded to multiples of patch·merge (28), CLIP
normalisation, cell-major patch packing, the Qwen2-VL chat template.
``PIL`` is imported only inside :func:`load_image_rgb` and
:func:`resize_bicubic`.
"""

from __future__ import annotations

import math
import re
from pathlib import Path
from typing import Protocol, Sequence, runtime_checkable

import numpy as np
import torch

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)

IM_START, IM_END = "<|im_start|>", "<|im_end|>"
VISION_START, VISION_END = "<|vision_start|>", "<|vision_end|>"
IMAGE_PAD = "<|image_pad|>"
DEFAULT_SYSTEM = "You are a helpful assistant."


def smart_resize(height: int, width: int, factor: int = 28,
                 min_pixels: int = 256 * 256,
                 max_pixels: int = 1024 * 1024) -> tuple[int, int]:
    """Target (h, w): factor-aligned, aspect-preserving, pixel-clamped."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError("absolute aspect ratio must be smaller than 200")
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def aligned_smart_size(height: int, width: int, factor: int = 28,
                       min_pixels: int = 256 * 256,
                       max_pixels: int = 1024 * 1024) -> tuple[int, int]:
    """smart_resize target, used for load-time resizing."""
    return smart_resize(height, width, factor, min_pixels, max_pixels)


def load_image_rgb(path: str | Path) -> np.ndarray:
    """uint8 [H, W, 3] RGB from an image file (needs PIL)."""
    from PIL import Image
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def resize_bicubic(image: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """PIL bicubic resize to (h, w) — the HF processor's resample (needs PIL)."""
    from PIL import Image
    h, w = size
    if image.dtype != np.uint8:
        image = np.clip(image, 0, 255).astype(np.uint8)
    if image.ndim == 2:
        image = np.stack([image] * 3, axis=-1)
    return np.asarray(Image.fromarray(image).resize((w, h), Image.BICUBIC))


def pack_image_device(image: torch.Tensor, *, patch_size: int = 14,
                      merge_size: int = 2, temporal_patch_size: int = 2):
    """Patch packing on the image's device: normalise + patchify, no resize.

    ``image``: uint8 [H, W] or [H, W, 3] with H and W multiples of
    patch·merge (28). Returns (patches [S, C·T·ps·ps] float32, grid).
    """
    if image.dim() == 2:
        image = torch.stack([image] * 3, dim=-1)
    height, width = image.shape[:2]
    factor = patch_size * merge_size
    if height % factor or width % factor:
        raise ValueError(f"image {height}x{width} not {factor}-aligned")
    mean = torch.as_tensor(CLIP_MEAN, device=image.device)
    std = torch.as_tensor(CLIP_STD, device=image.device)
    pixels = image.float() / 255.0
    pixels = (pixels - mean) / std
    chw = pixels.permute(2, 0, 1)
    frames = chw.expand(temporal_patch_size, *chw.shape)
    grid_h, grid_w = height // patch_size, width // patch_size
    ps, merge = patch_size, merge_size
    packed = frames.reshape(
        1, temporal_patch_size, 3,
        grid_h // merge, merge, ps,
        grid_w // merge, merge, ps,
    ).permute(0, 3, 6, 4, 7, 2, 1, 5, 8)
    patches = packed.reshape(grid_h * grid_w, 3 * temporal_patch_size * ps * ps)
    return patches, (1, grid_h, grid_w)


# ── tokenizer protocol + chat template ──────────────────────────────

@runtime_checkable
class TextTokenizer(Protocol):
    """Minimal tokenizer surface the engines need."""

    def encode(self, text: str) -> list[int]: ...
    def decode(self, ids: Sequence[int]) -> str: ...


class ByteTokenizer:
    """Model-free tokenizer: chars → byte ids, ``<|...|>`` specials → the
    real Qwen special ids. Lets a read run without tokenizer files while
    the prompt keeps its real structure."""

    SPECIALS = {
        IM_START: 151644, IM_END: 151645,
        VISION_START: 151652, VISION_END: 151653, IMAGE_PAD: 151655,
        "<think>": 151667, "</think>": 151668,
    }

    def __init__(self) -> None:
        self._pattern = re.compile(
            "|".join(re.escape(s) for s in self.SPECIALS))

    def encode(self, text: str) -> list[int]:
        out: list[int] = []
        pos = 0
        for match in self._pattern.finditer(text):
            out.extend(min(ord(c), 255) for c in text[pos:match.start()])
            out.append(self.SPECIALS[match.group()])
            pos = match.end()
        out.extend(min(ord(c), 255) for c in text[pos:])
        return out

    def decode(self, ids) -> str:
        return "".join(chr(i) for i in ids if i < 256)


def vlm_chat_prompt(user_text: str, num_image_tokens: int,
                    system: str = DEFAULT_SYSTEM) -> str:
    """Qwen2-VL chat-template prompt with one image before the user text."""
    vision = f"{VISION_START}{IMAGE_PAD * num_image_tokens}{VISION_END}"
    return (
        f"{IM_START}system\n{system}{IM_END}\n"
        f"{IM_START}user\n{vision}{user_text}{IM_END}\n"
        f"{IM_START}assistant\n"
    )


def llm_chat_prompt(system: str, user_text: str,
                    enable_thinking: bool = False) -> str:
    """Qwen3 chat-template prompt (non-thinking mode appends an empty
    think block)."""
    parts = []
    if system:
        parts.append(f"{IM_START}system\n{system}{IM_END}\n")
    parts.append(f"{IM_START}user\n{user_text}{IM_END}\n")
    parts.append(f"{IM_START}assistant\n")
    if not enable_thinking:
        parts.append("<think>\n\n</think>\n\n")
    return "".join(parts)
