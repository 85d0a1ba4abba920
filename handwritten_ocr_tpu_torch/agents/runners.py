"""The three reasoning agents: critic, editor, arbitrator (port of
``handwritten_ocr_tpu/agents/runners.py``).

Each agent makes one structured LLM call, validates the JSON against its
contract (``agents/schemas.py``) and substitutes a safe fallback on
validation failure —
  * critic     → confidence 0 / verdict "needs_editing"
  * editor     → input text unchanged
  * arbitrator → first version wins

Prompts and parsers are the JAX package's, word for word; the contracts
are the port's plain classes in place of pydantic models. The runners
take an explicit ``backend``, so the same code drives the torch reasoning
engine or scripted test fakes.
"""

from __future__ import annotations

from typing import NamedTuple

from handwritten_ocr_tpu_torch.agents.schema_prompt import schema_example
from handwritten_ocr_tpu_torch.agents.schemas import (ArbitratorResult,
                                                      CriticResult,
                                                      EditorResult,
                                                      ValidationError)
from handwritten_ocr_tpu_torch.engine.llm_client import (ReasoningBackend,
                                                         call_llm_json)


class AgentRequest(NamedTuple):
    """One structured LLM call: (system prompt, user message, json schema).

    The request/parse split lets the lockstep batch driver issue many
    agents' calls as one batched decode (graph/batch_driver.py) while the
    single-page runners keep one call per agent.
    """

    system: str
    user: str
    schema: dict

# ── Critic ───────────────────────────────────────────────────────────

CRITIC_SYSTEM_PROMPT = """\
You are an expert reviewer of OCR transcriptions of handwritten documents.
The original image is NOT available to you — judge the text on linguistic
evidence alone.

Your task: find transcription problems through careful linguistic analysis.

Watch for:
- Non-words or letter sequences that aren't real words
- Words the OCR fragmented into pieces ("inter alio ing" for "internalizing")
- Separate words fused into one blob
- Classic OCR confusions: "rn" read as "m", "cl" as "d", "li" as "h"
- Punctuation that is missing or garbled
- Sentences that fail to parse grammatically
- Numbers or dates that are implausible in context
- Erratic formatting or random capitalization
- Isolated stray characters that are scanner noise (a lone "a", "y", "H", ...)

Severity scale:
- "critical": the word/phrase is unintelligible or completely wrong
- "minor": slightly garbled but the meaning is recoverable
- "cosmetic": punctuation, spacing, or capitalization only

Be thorough yet precise — unusual writing style alone is not an error."""

CRITIC_USER_TEMPLATE = """\
Analyze the following OCR transcription for errors and quality issues.

## Transcription
{transcription}

{previous_critique_section}

## Output format
Respond with ONLY a JSON object matching this schema:
{schema}

Guidelines for verdict:
- "accept": text is coherent and readable, no critical issues, confidence > 85
- "needs_editing": text has identifiable issues that can be fixed from context
- "needs_reocr": text is so garbled that linguistic correction alone won't recover it"""


def critic_request(transcription: str,
                   previous_critique: CriticResult | None = None) -> AgentRequest:
    """Build the critic's (system, user, schema) triple."""
    previous_section = ""
    if previous_critique:
        previous_section = (
            "## Previous Critique (for context — the text was edited since)\n"
            f"Previous confidence: {previous_critique.overall_confidence}\n"
            f"Previous verdict: {previous_critique.verdict}\n"
            f"Previous reasoning: {previous_critique.reasoning}"
        )
    user_msg = CRITIC_USER_TEMPLATE.format(
        transcription=transcription,
        previous_critique_section=previous_section,
        schema=schema_example(CriticResult),
    )
    return AgentRequest(CRITIC_SYSTEM_PROMPT, user_msg,
                        CriticResult.json_schema())


def parse_critic(raw: dict, quiet: bool = False) -> CriticResult:
    """Validate critic JSON; fallback confidence 0 / needs_editing."""
    try:
        return CriticResult.validate(raw)
    except ValidationError as err:
        if not quiet:
            print(f"  [critic] WARNING: output validation failed: {err}")
        return CriticResult(
            overall_confidence=0,
            verdict="needs_editing",
            reasoning="LLM output failed schema validation",
        )


def run_critic(
    backend: ReasoningBackend,
    transcription: str,
    previous_critique: CriticResult | None = None,
    quiet: bool = False,
    max_tokens: int | None = None,
) -> CriticResult:
    """Critique a transcription; returns a validated CriticResult.

    ``max_tokens`` overrides the config decode budget for this call (the
    run snapshot's ``llm_max_tokens``); None keeps config.LLM_MAX_TOKENS.
    """
    request = critic_request(transcription, previous_critique)
    if not quiet:
        print("  [critic] Analyzing transcription...")
    raw = call_llm_json(backend, request.system, request.user,
                        max_tokens=max_tokens,
                        json_schema=request.schema, quiet=quiet)
    result = parse_critic(raw, quiet=quiet)
    if not quiet:
        print(f"  [critic] Verdict: {result.verdict} "
              f"(confidence {result.overall_confidence})")
    return result


# ── Editor ───────────────────────────────────────────────────────────

EDITOR_SYSTEM_PROMPT = """\
You are a careful restoration editor for OCR transcriptions.
The original image is NOT available to you — work from the text and the
critic's findings alone.

Hard rules:
1. Repair ONLY what the critic flagged. No rephrasing, no paraphrasing.
2. Everywhere the critic raised no issue, keep the wording byte-for-byte.
3. Explain every change you make and why.
4. An issue you cannot fix with confidence goes in the unresolved list.
5. Never invent content or rewrite sentences — you only undo OCR damage.

Think of it as uncovering the original text hidden behind OCR errors,
never as authoring new text."""

EDITOR_USER_TEMPLATE = """\
Fix the issues identified by the critic in this OCR transcription.

## Transcription
{transcription}

## Critic's Findings
Overall confidence: {confidence}
Issues found:
{issues_text}

## Output format
Respond with ONLY a JSON object matching this schema:
{schema}

IMPORTANT: The corrected_text must be the COMPLETE transcription with fixes applied, not just the changed parts."""


def format_critic_issues(critique: CriticResult) -> list[str]:
    """Issue bullet lines shown to the editor."""
    lines = [
        f"- [{issue.severity}] \"{segment.text}\" → {issue.description} "
        f"(suggestion: {issue.suggestion or 'none'})"
        for segment in critique.segments
        for issue in segment.issues
    ]
    return lines or ["No specific issues listed."]


def editor_request(transcription: str, critique: CriticResult) -> AgentRequest:
    """Build the editor's (system, user, schema) triple."""
    user_msg = EDITOR_USER_TEMPLATE.format(
        transcription=transcription,
        confidence=critique.overall_confidence,
        issues_text="\n".join(format_critic_issues(critique)),
        schema=schema_example(EditorResult),
    )
    return AgentRequest(EDITOR_SYSTEM_PROMPT, user_msg,
                        EditorResult.json_schema())


def parse_editor(raw: dict, transcription: str, quiet: bool = False) -> EditorResult:
    """Validate editor JSON; fallback keeps the input."""
    try:
        return EditorResult.validate(raw)
    except ValidationError as err:
        if not quiet:
            print(f"  [editor] WARNING: output validation failed: {err}")
        return EditorResult(corrected_text=transcription)


def run_editor(
    backend: ReasoningBackend,
    transcription: str,
    critique: CriticResult,
    quiet: bool = False,
    max_tokens: int | None = None,
) -> EditorResult:
    """Fix critic-flagged issues; returns a validated EditorResult."""
    request = editor_request(transcription, critique)
    if not quiet:
        print("  [editor] Fixing flagged issues...")
    raw = call_llm_json(backend, request.system, request.user,
                        max_tokens=max_tokens,
                        json_schema=request.schema, quiet=quiet)
    result = parse_editor(raw, transcription, quiet=quiet)
    if not quiet:
        print(f"  [editor] Applied {len(result.changes)} fixes, "
              f"{len(result.unresolved)} unresolved")
    return result


# ── Arbitrator ───────────────────────────────────────────────────────

ARBITRATOR_SYSTEM_PROMPT = """\
You are an arbitrator weighing multiple OCR transcription versions of one document.
The original image is NOT available to you — decide from the text versions alone.

Procedure:
1. Walk the versions segment by segment
2. At each disagreement, choose the reading that is most linguistically coherent
3. Weigh grammar, context, common OCR error patterns, and word frequency
4. Emit a single merged transcription assembled from the best parts of each version
5. Flag any segment where no version is convincing

Common OCR error patterns:
- "rn" ↔ "m", "cl" ↔ "d", "li" ↔ "h" (character confusion)
- Split words: fragments that should be one word
- Merged words: one blob that should be two words
- Stray characters: noise from the scanning process"""

ARBITRATOR_USER_TEMPLATE = """\
Compare these OCR transcription versions and produce the best merged result.

{versions_text}

## Output format
Respond with ONLY a JSON object matching this schema:
{schema}"""


def format_versions(versions: list[dict]) -> str:
    """Version blocks shown to the arbitrator."""
    blocks = []
    for idx, version in enumerate(versions, 1):
        score_info = f" (critic score: {version.get('score', 'N/A')})" if "score" in version else ""
        blocks.append(
            f"## Version {idx} — {version.get('source', 'unknown')}{score_info}\n"
            f"{version['text']}"
        )
    return "\n\n".join(blocks)


def arbitrator_request(versions: list[dict]) -> AgentRequest:
    """Build the arbitrator's (system, user, schema) triple."""
    user_msg = ARBITRATOR_USER_TEMPLATE.format(
        versions_text=format_versions(versions),
        schema=schema_example(ArbitratorResult),
    )
    return AgentRequest(ARBITRATOR_SYSTEM_PROMPT, user_msg,
                        ArbitratorResult.json_schema())


def parse_arbitrator(raw: dict, versions: list[dict],
                     quiet: bool = False) -> ArbitratorResult:
    """Validate arbitrator JSON; fallback = first version."""
    try:
        return ArbitratorResult.validate(raw)
    except ValidationError as err:
        if not quiet:
            print(f"  [arbitrator] WARNING: output validation failed: {err}")
        return ArbitratorResult(final_text=versions[0]["text"] if versions else "")


def run_arbitrator(
    backend: ReasoningBackend,
    versions: list[dict],
    quiet: bool = False,
    max_tokens: int | None = None,
) -> ArbitratorResult:
    """Merge version dicts ({text, source, score?}); validated ArbitratorResult."""
    request = arbitrator_request(versions)
    if not quiet:
        print(f"  [arbitrator] Comparing {len(versions)} versions...")
    raw = call_llm_json(backend, request.system, request.user,
                        max_tokens=max_tokens,
                        json_schema=request.schema, quiet=quiet)
    result = parse_arbitrator(raw, versions, quiet=quiet)
    if not quiet:
        print(f"  [arbitrator] Merged (confidence {result.confidence})")
    return result
