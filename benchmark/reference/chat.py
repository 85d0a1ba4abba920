"""The reasoner's chat prompt and the model-free tokenizer both sides use.

``DenseTokenizer`` encodes as the port's ``ByteTokenizer`` does (every
character its code point capped at 255, the ``<|...|>`` and think markers
Qwen's special ids; a frozen copy of ``handwritten_ocr_tpu_torch/models/
processor.py:286``) and decodes one character per id, ``chr(id % 256)``,
as ``chip_smoke.py:dense_tokenizer`` does, so that every id of the
vocabulary decodes to text and a random model's answers fill the schema's
string values. ``chat_prompt`` is Qwen3's chat template in non-thinking
mode (``processor.py:311``, ``llm_chat_prompt``).
"""

from __future__ import annotations

import re

SPECIALS = {"<|im_start|>": 151644, "<|im_end|>": 151645,
            "<|vision_start|>": 151652, "<|vision_end|>": 151653,
            "<|image_pad|>": 151655, "<think>": 151667, "</think>": 151668}
_PATTERN = re.compile("|".join(re.escape(s) for s in SPECIALS))


class DenseTokenizer:
    def encode(self, text: str) -> list[int]:
        out: list[int] = []
        pos = 0
        for match in _PATTERN.finditer(text):
            out.extend(min(ord(c), 255) for c in text[pos:match.start()])
            out.append(SPECIALS[match.group()])
            pos = match.end()
        out.extend(min(ord(c), 255) for c in text[pos:])
        return out

    def decode(self, ids) -> str:
        return "".join(chr(int(i) % 256) for i in ids)


def chat_prompt(system: str, user: str) -> str:
    head = f"<|im_start|>system\n{system}<|im_end|>\n" if system else ""
    return (head + f"<|im_start|>user\n{user}<|im_end|>\n"
            "<|im_start|>assistant\n<think>\n\n</think>\n\n")
