"""The port's scripted backends (``engine/fakes.py``) against the JAX
package's: the same answers, the same call records and the same
AssertionError texts when a queue runs dry, for every kind of scripted
item."""

import dataclasses

import pytest

from handwritten_ocr_tpu.engine import fakes as jax_fakes
from handwritten_ocr_tpu_torch.engine import fakes


def _answer(system, user):
    return f"{system}|{user}"


SCRIPTS = {
    "dict": [{"verdict": "accept", "overall_confidence": 95}],
    "string": ["raw text", ""],
    "callable": [_answer],
    "mixed": [{"a": [1, "ü"]}, "two", _answer, {"b": None}],
    "empty": [],
}


def _chat_run(module, script, pushed):
    backend = module.ScriptedReasoningBackend(script)
    assert backend.push(*pushed) is backend
    answers = []
    for i in range(len(script) + len(pushed) + 1):
        schema = {"type": "object"} if i % 2 else None
        try:
            answers.append(backend.chat(f"sys{i}", f"user{i}",
                                        temperature=0.1 * i, max_tokens=8 + i,
                                        json_schema=schema))
        except AssertionError as exc:
            answers.append(("AssertionError", str(exc)))
    return answers, backend.calls, backend.queue


@pytest.mark.parametrize("name", sorted(SCRIPTS))
@pytest.mark.parametrize("pushed", [(), ("pushed", {"x": 1})])
def test_reasoning_fake_matches_jax(name, pushed):
    got = _chat_run(fakes, SCRIPTS[name], pushed)
    assert got == _chat_run(jax_fakes, SCRIPTS[name], pushed)
    assert got[0][-1] == ("AssertionError", "ScriptedReasoningBackend: "
                                            "response queue exhausted")


@dataclasses.dataclass(frozen=True)
class Prepared:
    data: str
    strategy_label: str
    source_path: str


OCR_CASES = {
    "by_label": (dict(by_key={"a": "read a", "b": "read b"}),
                 [Prepared("x", "a", "/p"), Prepared("y", "b", "/p"),
                  Prepared("z", "a", "/q")]),
    "in_order": (dict(texts=["one", "two", "three"]),
                 [Prepared("x", "a", "/p"), "plain-path.png"]),
    "by_path_then_order": (dict(texts=["first"], by_key={"p.png": "keyed"}),
                           ["p.png", Prepared("x", "", "/p"), "p.png"]),
    "runs_dry": (dict(texts=["only"]), ["a.png", "b.png"]),
}


def _ocr_run(module, kwargs, images):
    backend = module.ScriptedOCRBackend(**kwargs)
    out = []
    for image in images:
        try:
            out.append(backend.read(image, "prompt", 12))
        except AssertionError as exc:
            out.append(("AssertionError", str(exc)))
    try:
        out.append(backend.read_batch(images[:2], "batch", 3))
    except AssertionError as exc:
        out.append(("AssertionError", str(exc)))
    backend.release()
    backend.release()
    calls = [(c["image"], c["prompt"], c["max_new_tokens"])
             for c in backend.calls]
    return out, calls, backend.texts, backend.release_count


@pytest.mark.parametrize("name", sorted(OCR_CASES))
def test_ocr_fake_matches_jax(name):
    kwargs, images = OCR_CASES[name]
    got = _ocr_run(fakes, kwargs, images)
    assert got == _ocr_run(jax_fakes, kwargs, images)
    assert got[3] == 2


def test_ocr_fake_runs_dry_with_the_jax_text():
    out = _ocr_run(fakes, *OCR_CASES["runs_dry"])[0]
    assert ("AssertionError",
            "ScriptedOCRBackend: out of scripted texts") in out
