"""The agent layer of the port against the JAX package's: the contracts
(plain classes against pydantic), the schema prompt, the runners' prompts
and parsers, the JSON ladder (each package's scripted fakes on its side), and
the pure text tools (``text/``, ``utils/jsonio.py``) on fuzz corpora.
"""

import json

import pydantic
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from handwritten_ocr_tpu.agents import runners as jax_runners
from handwritten_ocr_tpu.agents import schemas as jax_schemas
from handwritten_ocr_tpu.agents.schema_prompt import (
    schema_example as jax_schema_example)
from handwritten_ocr_tpu.engine import llm_client as jax_llm_client
from handwritten_ocr_tpu.engine import fakes as jax_fakes
from handwritten_ocr_tpu.text import diff as jax_diff
from handwritten_ocr_tpu.text import gt as jax_gt
from handwritten_ocr_tpu.text import merge as jax_merge
from handwritten_ocr_tpu.text import metrics as jax_metrics
from handwritten_ocr_tpu.text import normalize as jax_normalize
from handwritten_ocr_tpu.utils import jsonio as jax_jsonio
from handwritten_ocr_tpu_torch.agents import runners, schemas
from handwritten_ocr_tpu_torch.agents.schema_prompt import schema_example
from handwritten_ocr_tpu_torch.engine import fakes, llm_client
from handwritten_ocr_tpu_torch.text import diff, gt, merge, metrics, normalize
from handwritten_ocr_tpu_torch.utils import jsonio

NAMES = ["CriticIssue", "CriticSegment", "CriticResult", "EditorChange",
         "EditorResult", "ArbitratorDecision", "ArbitratorResult"]
FIELD_NAMES = sorted({f.name for name in NAMES
                      for f in getattr(schemas, name).FIELDS})
FUZZ = settings(max_examples=150, deadline=None, derandomize=True)


@pytest.mark.parametrize("name", NAMES)
def test_json_schema_equals_pydantic(name):
    got = getattr(schemas, name).json_schema()
    want = getattr(jax_schemas, name).model_json_schema()
    assert got == want
    assert json.dumps(got) == json.dumps(want)      # key order too


@pytest.mark.parametrize("name", NAMES)
def test_schema_example_matches_jax(name):
    assert schema_example(getattr(schemas, name)) == \
        jax_schema_example(getattr(jax_schemas, name))


# ── validate / dump against pydantic's lax mode ─────────────────────

INT_TEXT = st.from_regex(r"[ \t\n\xa0]{0,2}[+-]{0,2}[0-9_]{0,4}(\.[0-9]{0,2})?"
                         r"[ \t\n\x1c]{0,2}", fullmatch=True)
SCALARS = st.one_of(
    st.none(), st.booleans(), st.integers(-5, 150),
    st.floats(allow_nan=True, allow_infinity=True), st.text(max_size=5),
    INT_TEXT, st.sampled_from(["accept", "needs_editing", "needs_reocr",
                               "critical", "minor", "cosmetic", "Accept",
                               " minor", "100", "101", "-1", "0.0"]))
VALUES = st.recursive(
    SCALARS,
    lambda inner: st.lists(inner, max_size=3)
    | st.dictionaries(st.sampled_from(FIELD_NAMES + ["extra"]), inner,
                      max_size=4),
    max_leaves=10)
RAW = st.one_of(
    st.dictionaries(st.sampled_from(FIELD_NAMES + ["extra"]), VALUES,
                    max_size=5),
    VALUES)


def outcome(validate, dump, error, raw):
    try:
        return dump(validate(raw))
    except error:
        return "invalid"


@FUZZ
@given(raw=RAW, name=st.sampled_from(NAMES))
def test_validate_and_dump_agree_with_pydantic(raw, name):
    port, ref = getattr(schemas, name), getattr(jax_schemas, name)
    got = outcome(port.validate, lambda m: m.dump(), schemas.ValidationError,
                  raw)
    want = outcome(ref.model_validate, lambda m: m.model_dump(),
                   pydantic.ValidationError, raw)
    assert got == want


@pytest.mark.parametrize("raw", [
    {"overall_confidence": "85", "verdict": "accept", "junk": 1},
    {"overall_confidence": 85.0, "segments": [{"confidence": " 7 "}]},
    {"overall_confidence": 85.5}, {"overall_confidence": 101},
    {"overall_confidence": "8_5"}, {"reasoning": 5},
    {"verdict": "Accept"}, {"segments": "x"}, {"segments": [None]},
    [], "x", None])
def test_validate_corner_cases_agree_with_pydantic(raw):
    got = outcome(schemas.CriticResult.validate, lambda m: m.dump(),
                  schemas.ValidationError, raw)
    want = outcome(jax_schemas.CriticResult.model_validate,
                   lambda m: m.model_dump(), pydantic.ValidationError, raw)
    assert got == want


def test_constructor_defaults_and_required_fields():
    assert schemas.CriticResult().dump() == jax_schemas.CriticResult().model_dump()
    assert schemas.EditorResult(corrected_text="x").dump() == \
        jax_schemas.EditorResult(corrected_text="x").model_dump()
    with pytest.raises(schemas.ValidationError):
        schemas.EditorResult()
    with pytest.raises(schemas.ValidationError):
        schemas.ArbitratorResult.validate({"decisions": []})


# ── runners: prompts, parsers, fallbacks ────────────────────────────

CRITIQUE = {"overall_confidence": 40, "verdict": "needs_editing",
            "reasoning": "garbled",
            "segments": [{"text": "teh", "confidence": 30, "issues": [
                {"description": "typo", "severity": "critical",
                 "suggestion": "the"},
                {"description": "odd", "severity": "cosmetic"}]}]}
VERSIONS = [{"text": "the cat", "source": "current_best", "score": 70},
            {"text": "teh cat", "source": "ocr_deskew+high_contrast+sharpen"}]


def test_request_prompts_match_jax():
    port_prev = schemas.CriticResult.validate(CRITIQUE)
    jax_prev = jax_schemas.CriticResult.model_validate(CRITIQUE)
    pairs = [
        (runners.critic_request("teh cat"), jax_runners.critic_request("teh cat")),
        (runners.critic_request("teh cat", port_prev),
         jax_runners.critic_request("teh cat", jax_prev)),
        (runners.editor_request("teh cat", port_prev),
         jax_runners.editor_request("teh cat", jax_prev)),
        (runners.editor_request("x", schemas.CriticResult()),
         jax_runners.editor_request("x", jax_schemas.CriticResult())),
        (runners.arbitrator_request(VERSIONS),
         jax_runners.arbitrator_request(VERSIONS)),
    ]
    for got, want in pairs:
        assert tuple(got) == tuple(want)
    assert runners.format_critic_issues(port_prev) == \
        jax_runners.format_critic_issues(jax_prev)


ANSWERS = {
    "critic": [json.dumps(CRITIQUE), '{"overall_confidence": 150}', "junk"],
    "editor": ['{"corrected_text": "the cat", "unresolved": ["x"]}',
               '{"changes": []}', "junk"],
    "arbitrator": ['{"final_text": "the cat", "confidence": "77"}',
                   '{"final_text": 5}', "junk"],
}


def _run(module, schema_module, fake, agent, answer):
    """(result dump, the fake's calls) of one agent run on a scripted
    backend; an unparseable answer walks the whole ladder."""
    backend = fake.ScriptedReasoningBackend([answer] * 3)
    prev = schema_module.CriticResult.validate(CRITIQUE) \
        if schema_module is schemas else \
        schema_module.CriticResult.model_validate(CRITIQUE)
    if agent == "critic":
        result = module.run_critic(backend, "teh cat", prev, quiet=True,
                                   max_tokens=64)
    elif agent == "editor":
        result = module.run_editor(backend, "teh cat", prev, quiet=True)
    else:
        result = module.run_arbitrator(backend, VERSIONS, quiet=True)
    dump = result.dump() if schema_module is schemas else result.model_dump()
    return dump, backend.calls


@pytest.mark.parametrize("agent,answer", [
    (agent, answer) for agent, answers in ANSWERS.items()
    for answer in answers])
def test_runners_match_jax(agent, answer):
    assert _run(runners, schemas, fakes, agent, answer) == \
        _run(jax_runners, jax_schemas, jax_fakes, agent, answer)


@pytest.mark.parametrize("script", [
    [{"a": 1}],                                # tier 1: structured
    ["no json", {"a": 2}],                     # tier 2: free text
    ["no json", "still none", '```json\n{"a": 3}\n```'],   # tier 3
    ["x", "y", "z"],                           # every tier fails
])
def test_ladder_matches_jax(script):
    results = []
    for module, fake in ((llm_client, fakes), (jax_llm_client, jax_fakes)):
        backend = fake.ScriptedReasoningBackend(list(script))
        out = module.call_llm_json(backend, "sys", "user", max_tokens=32,
                                   json_schema={"type": "object"}, quiet=True)
        results.append((out, backend.calls))
    assert results[0] == results[1]


def batch_fake(fake):
    """``fake.ScriptedReasoningBackend`` with ``chat_batch``: rows answered
    from the queue, each call recorded with its schema."""

    class BatchFake(fake.ScriptedReasoningBackend):
        def chat_batch(self, requests, *, temperature, max_tokens,
                       json_schema=None):
            self.calls.append({"batch": len(requests),
                               "json_schema": json_schema,
                               "max_tokens": max_tokens})
            return [self.chat(r.system, r.user, temperature=temperature,
                              max_tokens=max_tokens, json_schema=json_schema)
                    for r in requests]
    return BatchFake


@pytest.mark.parametrize("batched", [True, False])
def test_batch_ladder_matches_jax(batched):
    results = []
    for module, run_mod, fake in ((llm_client, runners, fakes),
                                  (jax_llm_client, jax_runners, jax_fakes)):
        cls = batch_fake(fake) if batched else fake.ScriptedReasoningBackend
        backend = cls(['{"final_text": "a"}', "junk", '{"final_text": "b"}'])
        requests = [run_mod.arbitrator_request(VERSIONS),
                    run_mod.arbitrator_request(VERSIONS[::-1])]
        out = module.call_llm_json_batch(backend, requests, max_tokens=16,
                                         quiet=True)
        results.append((out, backend.calls))
    assert results[0] == results[1]


# ── text tools and JSON extraction on fuzz corpora ──────────────────

WORDS = st.lists(st.sampled_from(["the", "The", "cat", "sat", "on", "a",
                                  "mat", "teh", "c4t", "—", "“quoted”",
                                  "rn", "m", "", " ", "\t", "\n"]),
                 max_size=14).map(" ".join)
TEXT = st.one_of(WORDS, st.text(max_size=30))


@FUZZ
@given(a=TEXT, b=TEXT, lower=st.booleans())
def test_text_metrics_match_jax(a, b, lower):
    assert normalize.normalize_text(a, lower) == \
        jax_normalize.normalize_text(a, lower)
    assert metrics.levenshtein(a, b) == jax_metrics.levenshtein(a, b)
    assert metrics.word_levenshtein(a.split(), b.split()) == \
        jax_metrics.word_levenshtein(a.split(), b.split())
    assert metrics.cer(a, b, lower) == jax_metrics.cer(a, b, lower)
    assert metrics.wer(a, b, lower) == jax_metrics.wer(a, b, lower)
    assert metrics.tier1_metrics(a, b, lower) == \
        jax_metrics.tier1_metrics(a, b, lower)
    assert diff.compare_versions(a, b) == jax_diff.compare_versions(a, b)


@FUZZ
@given(versions=st.lists(WORDS, max_size=4))
def test_merge_matches_jax(versions):
    assert merge.merge_versions(versions) == jax_merge.merge_versions(versions)
    if versions:
        backbone = versions[0].split()
        for other in versions:
            assert merge.align_to_backbone(backbone, other.split()) == \
                jax_merge.align_to_backbone(backbone, other.split())


@FUZZ
@given(raw=st.one_of(
    st.text(max_size=40),
    st.recursive(st.one_of(st.integers(), st.text(max_size=4), st.none()),
                 lambda inner: st.lists(inner, max_size=3)
                 | st.dictionaries(st.text(max_size=3), inner, max_size=3),
                 max_leaves=6).map(json.dumps),
    st.tuples(st.sampled_from(["", "```json\n", "Sure: ", "```"]),
              st.text(alphabet='{}[]":,ab1 ', max_size=20),
              st.sampled_from(["", "\n```", " trailing", "}"])).map("".join)))
def test_extract_json_matches_jax(raw):
    assert jsonio.extract_json(raw) == jax_jsonio.extract_json(raw)


@pytest.mark.parametrize("body", ["# Page\n## Ground Truth\n  the cat \n",
                                  "plain text only\n", "## Ground Truth\n   \n",
                                  ""])
def test_parse_ground_truth_matches_jax(tmp_path, body):
    path = tmp_path / "gt.md"
    path.write_text(body, encoding="utf-8")
    assert gt.parse_ground_truth(path) == jax_gt.parse_ground_truth(path)
    assert gt.parse_ground_truth(tmp_path / "missing.md") is None
