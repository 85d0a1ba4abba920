"""Ollama HTTP reasoning backend, the parity mode (port of
``handwritten_ocr_tpu/engine/ollama_client.py``).

Speaks the Ollama ``/api/chat`` wire protocol directly over urllib (no
``ollama`` package): system + user messages (the system message only when
it is non-empty), temperature + num_predict options, ``format=<json
schema>`` for constrained output, and a ``think`` flag. Free-text calls
stream NDJSON when ``stream`` is on; schema calls never stream. The
daemon is ``host``, else ``OLLAMA_HOST``, else ``http://localhost:11434``.
It sends the same payload as the JAX package's client for the same call.
"""

from __future__ import annotations

import json
import os
import sys
import urllib.request

from handwritten_ocr_tpu_torch import config


class OllamaBackend:
    """Chat client for a local Ollama daemon."""

    def __init__(
        self,
        model: str = config.OLLAMA_MODEL,
        host: str | None = None,
        timeout: float = config.LLM_TIMEOUT,
        think: bool = config.LLM_ENABLE_THINKING,
        stream: bool = config.LLM_STREAM,
    ) -> None:
        self.model = model
        self.host = (host or os.environ.get("OLLAMA_HOST") or "http://localhost:11434").rstrip("/")
        self.timeout = timeout
        self.think = think
        self.stream = stream

    def chat(
        self,
        system_prompt: str,
        user_message: str,
        *,
        temperature: float,
        max_tokens: int,
        json_schema: dict | None = None,
    ) -> str:
        messages = []
        if system_prompt:
            messages.append({"role": "system", "content": system_prompt})
        messages.append({"role": "user", "content": user_message})

        should_stream = self.stream and json_schema is None
        payload: dict = {
            "model": self.model,
            "messages": messages,
            "stream": should_stream,
            "think": self.think,
            "options": {"temperature": temperature, "num_predict": max_tokens},
        }
        if json_schema is not None:
            payload["format"] = json_schema

        request = urllib.request.Request(
            f"{self.host}/api/chat",
            data=json.dumps(payload).encode("utf-8"),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(request, timeout=self.timeout) as response:
            if not should_stream:
                body = json.loads(response.read().decode("utf-8"))
                return body["message"]["content"]
            return self._drain_stream(response)

    @staticmethod
    def _drain_stream(response) -> str:
        """NDJSON stream → assembled text, echoing the tokens to stdout as
        they arrive."""
        chunks: list[str] = []
        for raw_line in response:
            line = raw_line.decode("utf-8").strip()
            if not line:
                continue
            part = json.loads(line)
            token = part.get("message", {}).get("content", "")
            if token:
                chunks.append(token)
                sys.stdout.write(token)
                sys.stdout.flush()
        sys.stdout.write("\n")
        sys.stdout.flush()
        return "".join(chunks)
