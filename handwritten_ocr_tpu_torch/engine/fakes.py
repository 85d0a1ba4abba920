"""Deterministic scripted backends for testing the pipeline without a
model (copied from ``handwritten_ocr_tpu/engine/fakes.py``).

Graph routing, plateau / exhaustion / max-iteration logic and the CLI's
artifacts are testable with them on any machine, the card's included:
they import neither torch nor JAX.
"""

from __future__ import annotations

import json
from typing import Callable, Sequence


class ScriptedReasoningBackend:
    """Replays a queue of canned responses; records every call.

    Each scripted item may be a dict (serialized to JSON), a raw string, or
    a callable ``(system_prompt, user_message) -> str``.
    """

    def __init__(self, responses: Sequence[dict | str | Callable] = ()):
        self.queue: list = list(responses)
        self.calls: list[dict] = []

    def push(self, *responses: dict | str | Callable) -> "ScriptedReasoningBackend":
        self.queue.extend(responses)
        return self

    def chat(self, system_prompt: str, user_message: str, *,
             temperature: float, max_tokens: int,
             json_schema: dict | None = None) -> str:
        self.calls.append({
            "system": system_prompt,
            "user": user_message,
            "temperature": temperature,
            "max_tokens": max_tokens,
            "json_schema": json_schema,
        })
        if not self.queue:
            raise AssertionError("ScriptedReasoningBackend: response queue exhausted")
        item = self.queue.pop(0)
        if callable(item):
            return item(system_prompt, user_message)
        if isinstance(item, dict):
            return json.dumps(item)
        return item


class ScriptedOCRBackend:
    """Maps (image identity or call order) to canned transcriptions."""

    def __init__(self, texts: Sequence[str] = (), by_key: dict | None = None):
        self.texts: list[str] = list(texts)
        self.by_key = dict(by_key or {})
        self.calls: list = []
        self.release_count = 0

    def read_batch(self, images: Sequence, prompt: str, max_new_tokens: int) -> list[str]:
        out = []
        for image in images:
            self.calls.append({"image": image, "prompt": prompt,
                               "max_new_tokens": max_new_tokens})
            key = getattr(image, "strategy_label", None) or image
            if key in self.by_key:
                out.append(self.by_key[key])
            elif self.texts:
                out.append(self.texts.pop(0))
            else:
                raise AssertionError("ScriptedOCRBackend: out of scripted texts")
        return out

    def read(self, image, prompt: str, max_new_tokens: int) -> str:
        return self.read_batch([image], prompt, max_new_tokens)[0]

    def release(self) -> None:
        self.release_count += 1
