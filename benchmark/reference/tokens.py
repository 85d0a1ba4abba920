"""Prompt ids and M-RoPE positions, written out for the reference.

The chat template (Qwen2-VL with one image before the user text) and the
byte-level ids of the port's model-free ``ByteTokenizer``: every
character is its code point capped at 255, and the ``<|...|>`` markers
are Qwen's special ids. Frozen copy of
``handwritten_ocr_tpu_torch/models/processor.py:238``
(``ByteTokenizer.encode``) and ``:265`` (``vlm_chat_prompt``).
"""

from __future__ import annotations

import re

import numpy as np

SPECIALS = {"<|im_start|>": 151644, "<|im_end|>": 151645,
            "<|vision_start|>": 151652, "<|vision_end|>": 151653,
            "<|image_pad|>": 151655}
_PATTERN = re.compile("|".join(re.escape(s) for s in SPECIALS))
IMAGE_TOKEN = SPECIALS["<|image_pad|>"]


def encode(text: str) -> list[int]:
    out: list[int] = []
    pos = 0
    for match in _PATTERN.finditer(text):
        out.extend(min(ord(c), 255) for c in text[pos:match.start()])
        out.append(SPECIALS[match.group()])
        pos = match.end()
    out.extend(min(ord(c), 255) for c in text[pos:])
    return out


def ocr_prompt(user_text: str, n_image_tokens: int,
               system: str = "You are a helpful assistant.") -> list[int]:
    vision = ("<|vision_start|>" + "<|image_pad|>" * n_image_tokens
              + "<|vision_end|>")
    return encode(f"<|im_start|>system\n{system}<|im_end|>\n"
                  f"<|im_start|>user\n{vision}{user_text}<|im_end|>\n"
                  f"<|im_start|>assistant\n")


def mrope_positions(ids: np.ndarray, grid: tuple[int, int, int],
                    merge: int, prompt: int | None = None) -> np.ndarray:
    """[3, T] position ids of a prompt with one image (Qwen2-VL's rule):
    text advances all three planes together; the image's merged cells take
    (t, row, col) coordinates offset to follow the text before it; the
    text after it continues from the largest position + 1. The image is
    looked for in the first ``prompt`` ids: a served token may be the
    image token's id, and is text."""
    ids = np.asarray(ids)
    total = len(ids)
    where = np.flatnonzero(ids[:prompt] == IMAGE_TOKEN)
    start, end = int(where[0]), int(where[-1]) + 1
    t, h, w = grid
    gh, gw = h // merge, w // merge
    if end - start != t * gh * gw:
        raise ValueError("image span does not match its grid")
    pos = np.zeros((3, total), np.int64)
    pos[:, :start] = np.arange(start)
    cells = np.arange(t * gh * gw)
    pos[0, start:end] = start + cells // (gh * gw)
    pos[1, start:end] = start + (cells // gw) % gh
    pos[2, start:end] = start + cells % gw
    nxt = int(pos[:, start:end].max()) + 1
    pos[:, end:] = nxt + np.arange(total - end)
    return pos
