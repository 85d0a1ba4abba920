"""Structured LLM calls with the robust JSON retry ladder (copied from
``handwritten_ocr_tpu/engine/llm_client.py``).

Contract: three tiers —
  1. native structured output (backend is given the JSON schema), parsed;
  2. free-text call, robust-parsed;
  3. retry with an explicit "ONLY valid JSON" suffix appended to the user
     message, robust-parsed;
  4. give up with ``{"error": "json_parse_failed", "raw_response": ...}``.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

from handwritten_ocr_tpu_torch import config
from handwritten_ocr_tpu_torch.utils.jsonio import extract_json

_JSON_ONLY_SUFFIX = (
    "\n\nIMPORTANT: Respond with ONLY valid JSON. No markdown, no preamble, "
    "no explanation."
)


def _accepts_json_schema(fn) -> bool:
    import inspect
    try:
        return "json_schema" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


@runtime_checkable
class ReasoningBackend(Protocol):
    """A chat LLM endpoint for the critic/editor/arbitrator agents."""

    def chat(
        self,
        system_prompt: str,
        user_message: str,
        *,
        temperature: float,
        max_tokens: int,
        json_schema: dict | None = None,
    ) -> str:
        """One chat turn; returns the assistant message text.

        ``json_schema`` non-None requests grammar-constrained JSON output
        when the backend supports it; backends without constrained decoding
        may ignore it (the parse ladder recovers).
        """
        ...


def call_llm_json(
    backend: ReasoningBackend,
    system_prompt: str,
    user_message: str,
    temperature: float | None = None,
    max_tokens: int | None = None,
    json_schema: dict | None = None,
    quiet: bool = False,
) -> dict:
    """Call the LLM and parse JSON with the 3-tier retry ladder."""
    temp = temperature if temperature is not None else config.LLM_TEMPERATURE
    n_tokens = max_tokens or config.LLM_MAX_TOKENS

    if json_schema is not None:
        if not quiet:
            print("  [llm] Calling reasoning model (structured)...", flush=True)
        text = backend.chat(
            system_prompt, user_message,
            temperature=temp, max_tokens=n_tokens, json_schema=json_schema,
        )
        parsed = extract_json(text)
        if parsed is not None:
            return parsed

    if not quiet:
        print("  [llm] Calling reasoning model...", flush=True)
    raw = backend.chat(system_prompt, user_message, temperature=temp, max_tokens=n_tokens)
    parsed = extract_json(raw)
    if parsed is not None:
        return parsed

    raw = backend.chat(
        system_prompt, user_message + _JSON_ONLY_SUFFIX,
        temperature=temp, max_tokens=n_tokens,
    )
    parsed = extract_json(raw)
    if parsed is not None:
        return parsed

    return {"error": "json_parse_failed", "raw_response": raw}


def call_llm_json_batch(
    backend: ReasoningBackend,
    requests,
    temperature: float | None = None,
    max_tokens: int | None = None,
    quiet: bool = False,
) -> list[dict]:
    """Batched structured calls (lockstep driver path).

    ``requests`` — AgentRequest-like (system, user, schema) triples. Uses
    the backend's ``chat_batch`` when available (one batched decode for
    all calls); any response that fails to parse falls back to the full
    single-call retry ladder.
    """
    temp = temperature if temperature is not None else config.LLM_TEMPERATURE
    n_tokens = max_tokens or config.LLM_MAX_TOKENS

    if hasattr(backend, "chat_batch"):
        if not quiet:
            print(f"  [llm] Batched reasoning call x{len(requests)}...",
                  flush=True)
        # Same-agent batches share one schema; pass it so the batch gets
        # tier-1 constrained output like single calls (backends without
        # the parameter keep the old free-decode behavior).
        schema = next((r.schema for r in requests if r.schema), None)
        kwargs = {}
        if schema is not None and _accepts_json_schema(backend.chat_batch):
            kwargs["json_schema"] = schema
        texts = backend.chat_batch(list(requests), temperature=temp,
                                   max_tokens=n_tokens, **kwargs)
    else:
        texts = [backend.chat(r.system, r.user, temperature=temp,
                              max_tokens=n_tokens, json_schema=r.schema)
                 for r in requests]

    results = []
    for request, text in zip(requests, texts):
        parsed = extract_json(text)
        if parsed is None:
            parsed = call_llm_json(backend, request.system, request.user,
                                   temperature=temp, max_tokens=n_tokens,
                                   json_schema=request.schema, quiet=quiet)
        results.append(parsed)
    return results
