"""The port's pipeline layer against the JAX package's: routing, the
single-page driver (``OCRPipeline.run``, snapshot and resume), the
lockstep driver (``LockstepPipeline.run_many``), state and trace.

Scripted backends (each package's own fakes, ``engine/fakes.py``, on
its side, and the lockstep tests' content-keyed fakes) drive every
routing branch through both packages' drivers; the final states and trace events must be equal, apart from
wall-clock fields. Then one rendered page goes through both drivers of
both packages with tiny real engines on the same weights.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from handwritten_ocr_tpu import config as jax_config
from handwritten_ocr_tpu import state as jax_state
from handwritten_ocr_tpu import trace as jax_trace
from handwritten_ocr_tpu.engine import fakes as jax_fakes
from handwritten_ocr_tpu.graph import batch_driver as jax_batch_driver
from handwritten_ocr_tpu.graph import driver as jax_driver
from handwritten_ocr_tpu.graph import routing as jax_routing
from handwritten_ocr_tpu_torch import config, state, trace
from handwritten_ocr_tpu_torch.engine import fakes
from handwritten_ocr_tpu_torch.graph import batch_driver, driver, routing
from test_graph import arbitrator_json, critic_json, editor_json
from test_lockstep import ContentKeyedLLM, PageKeyedOCR, critic

torch.set_num_threads(1)

PORT = dict(state=state, driver=driver, batch_driver=batch_driver,
            fakes=fakes)
JAX = dict(state=jax_state, driver=jax_driver, batch_driver=jax_batch_driver,
           fakes=jax_fakes)


def comparable(final: dict) -> dict:
    """A final state without its wall-clock fields."""
    out = {k: v for k, v in final.items() if k != "start_time"}
    out["trace_events"] = [
        {k: v for k, v in e.items() if k not in ("timestamp", "elapsed_seconds")}
        for e in final["trace_events"]]
    return json.loads(json.dumps(out))


@pytest.mark.parametrize("verdict", ["accept", "needs_editing", "needs_reocr"])
@pytest.mark.parametrize("confidence", [10, 84, 85, 90])
@pytest.mark.parametrize("plateau,iteration", [(0, 1), (2, 1), (0, 10), (5, 99)])
def test_routing_matches_jax(verdict, confidence, plateau, iteration):
    s = dict(critiques=[critic_json(confidence, verdict)],
             config=config.RunConfig().as_state_dict(),
             plateau_count=plateau, iteration=iteration, max_iterations=10)
    assert routing.route_after_critic(s) == jax_routing.route_after_critic(s)
    for reason in ("exhausted", "", "accept"):
        assert routing.route_after_reocr({"reason": reason}) == \
            jax_routing.route_after_reocr({"reason": reason})


def test_run_config_carries_every_knob_the_drivers_read():
    """The port's ``state['config']`` is the JAX package's plus the OCR
    prompt and both token budgets, at the JAX package's defaults; a
    field set on the snapshot reaches the dict."""
    port, ref = config.RunConfig(), jax_config.RunConfig()
    want = ref.as_state_dict() | {
        "ocr_prompt": ref.ocr_prompt,
        "ocr_max_new_tokens": ref.ocr_max_new_tokens,
        "llm_max_tokens": ref.llm_max_tokens}
    assert port.as_state_dict() == want
    assert port.max_iterations == ref.max_iterations
    got = config.RunConfig(ocr_prompt="p", ocr_max_new_tokens=7,
                           llm_max_tokens=9).as_state_dict()
    assert (got["ocr_prompt"], got["ocr_max_new_tokens"],
            got["llm_max_tokens"]) == ("p", 7, 9)


# ── single-page driver on scripted backends ─────────────────────────

SCENARIOS = {
    "accept_first": (dict(a="hello world", b="hello world"),
                     [critic_json(95, "accept")], {}),
    "tiebreak": (dict(a="aaaa bbbb cccc dddd", b="zzzz yyyy xxxx wwww",
                      c="aaaa bbbb cccc dddd"),
                 [critic_json(95, "accept")], {}),
    "edit_then_accept": (dict(a="teh text", b="teh text"), [
        critic_json(50, "needs_editing", issues=[("teh", "typo", "minor")]),
        editor_json("the text"), critic_json(95, "accept")], {}),
    "plateau": (dict(a="x", b="x"), [
        critic_json(50), editor_json("x1"), critic_json(50),
        editor_json("x2"), critic_json(49)], {}),
    "plateau_reset": (dict(a="x", b="x"), [
        critic_json(50), editor_json("x1"), critic_json(50),
        editor_json("x2"), critic_json(60), editor_json("x3"),
        critic_json(95, "accept")], {}),
    "max_iterations": (dict(a="x", b="x"), [
        critic_json(30), editor_json("x0"), critic_json(40),
        editor_json("x1"), critic_json(50), editor_json("x2"),
        critic_json(70)], dict(max_iterations=4)),
    "reocr_arbitrate": (dict(a="v1", b="v1", c="v3"), [
        critic_json(40, "needs_reocr"),
        arbitrator_json("arbitrated text", confidence=80),
        critic_json(95, "accept")], {}),
    "reocr_exhausted": (dict(a="v1", b="v1"), [
        critic_json(40, "needs_reocr")],
        dict(strategies=[["a"], ["b"]])),
    "duplicate_strategy": (dict(a="v1", b="v1"), [
        critic_json(40, "needs_reocr")],
        dict(strategies=[["a"], ["b"], ["a"]])),
    "critic_fallback": (dict(a="x", b="x"), [
        {"overall_confidence": 5000, "verdict": "accept"},
        editor_json("fixed"), critic_json(95, "accept")], {}),
    "editor_fallback": (dict(a="orig", b="orig"), [
        critic_json(50, "needs_editing"), {"nonsense": True},
        critic_json(50), {"nonsense": True}, critic_json(50)], {}),
    "unparseable_ladder": (dict(a="x", b="x"), [
        "no json", "still none", json.dumps(critic_json(95, "accept"))], {}),
    "empty_bank": (dict(original="raw read"), [critic_json(95, "accept")],
                   dict(strategies=[])),
}


def run_scenario(pkg: dict, reads: dict, answers: list, overrides: dict,
                 snapshot_path=None, resume=False):
    max_iterations = overrides.get("max_iterations", 10)
    cfg = config.RunConfig(
        strategies=overrides.get("strategies", [["a"], ["b"], ["c"]]),
        ocr_prompt="read", ocr_max_new_tokens=64)
    s = pkg["state"].initial_state("/img.png", config=cfg.as_state_dict(),
                                   max_iterations=max_iterations)
    ocr = pkg["fakes"].ScriptedOCRBackend(by_key=reads)
    llm = pkg["fakes"].ScriptedReasoningBackend(list(answers))
    final = pkg["driver"].OCRPipeline(ocr, llm, quiet=True).run(
        s, snapshot_path=snapshot_path, resume=resume)
    reads_seen = [(c["image"].strategy_label, c["image"].source_path,
                   c["prompt"], c["max_new_tokens"]) for c in ocr.calls]
    return comparable(final), reads_seen, llm.calls, ocr.release_count


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pipeline_run_matches_jax(name):
    reads, answers, overrides = SCENARIOS[name]
    got = run_scenario(PORT, reads, answers, overrides)
    assert got == run_scenario(JAX, reads, answers, overrides)
    assert got[0]["status"] in ("completed", "max_iterations")


def test_snapshot_and_resume_match_jax(tmp_path):
    """A crash at the second critic call leaves a snapshot after the
    editor; resuming runs only the rest. Both packages write the same
    snapshot and reach the same final state."""
    out = {}
    for name, pkg in (("port", PORT), ("jax", JAX)):
        snap = str(tmp_path / f"{name}.json")
        reads = dict(a="draft", b="draft")

        class Exploding(pkg["fakes"].ScriptedReasoningBackend):
            def chat(self, *args, **kwargs):
                if len(self.calls) == 2:
                    raise RuntimeError("simulated crash")
                return super().chat(*args, **kwargs)

        cfg = config.RunConfig(strategies=[["a"], ["b"]])
        s = pkg["state"].initial_state("/img.png", config=cfg.as_state_dict(),
                                       max_iterations=10)
        llm = Exploding([critic_json(50), editor_json("edited")])
        with pytest.raises(RuntimeError, match="simulated crash"):
            pkg["driver"].OCRPipeline(
                pkg["fakes"].ScriptedOCRBackend(by_key=reads), llm,
                quiet=True).run(s, snapshot_path=snap)
        saved = json.loads(open(snap).read())
        final = pkg["driver"].OCRPipeline(
            pkg["fakes"].ScriptedOCRBackend(),
            pkg["fakes"].ScriptedReasoningBackend(
                [critic_json(95, "accept")]), quiet=True).run(
            s, snapshot_path=snap, resume=True)
        out[name] = (saved["next_node"], comparable(saved["state"]),
                     comparable(final), (tmp_path / f"{name}.json").exists())
    assert out["port"] == out["jax"]
    assert out["port"][0] == "critic" and not out["port"][3]


# ── lockstep driver on scripted backends ────────────────────────────

LOCKSTEP = {
    "mixed": ([["a"], ["b"], ["c"]], 6, {
        ("/p0.png", "a"): "page zero words here",
        ("/p0.png", "b"): "page zero words here",
        ("/p1.png", "a"): "page one totally different text",
        ("/p1.png", "b"): "page one totally different text",
        ("/p1.png", "c"): "page one arbitrated read",
        ("/p2.png", "a"): "page two text", ("/p2.png", "b"): "page two text",
    }, {
        "page zero words here": [critic(95, "accept")],
        "page one totally different text": [critic(40, "needs_reocr")],
        "## Version 1": [{"final_text": "page one merged", "decisions": [],
                          "confidence": 80, "uncertain_segments": []}],
        "page one merged": [critic(90, "accept")],
        "page two text": [critic(50, "needs_editing")],
        "Critic's Findings": [{"corrected_text": "page two fixed",
                               "changes": [], "unresolved": []}],
        "page two fixed": [critic(92, "accept")],
    }),
    "exhausted_and_plateau": ([["a"], ["b"]], 9, {
        ("/p0.png", "a"): "xx yy", ("/p0.png", "b"): "xx yy",
        ("/p1.png", "a"): "zz ww", ("/p1.png", "b"): "zz ww",
    }, {
        "Critic's Findings": [
            {"corrected_text": "zz ww", "changes": [], "unresolved": []}] * 2,
        "xx yy": [critic(40, "needs_reocr")],
        "zz ww": [critic(50)] * 3,
    }),
    "tiebreak_and_max_iterations": ([["a"], ["b"], ["c"], ["d"]], 2, {
        ("/p0.png", "a"): "one two three", ("/p0.png", "b"): "four five six",
        ("/p0.png", "c"): "one two three", ("/p0.png", "d"): "one two tree",
    }, {
        "## Version 1": [{"final_text": "one two three", "confidence": 70}],
        "one two three": [critic(30, "needs_reocr"), critic(35)],
    }),
}


def run_lockstep(pkg, strategies, max_iterations, reads, script):
    cfg = config.RunConfig(strategies=strategies)
    pages = sorted({path for path, _ in reads})
    states = [pkg["state"].initial_state(p, config=cfg.as_state_dict(),
                                         max_iterations=max_iterations)
              for p in pages]
    ocr = PageKeyedOCR(dict(reads))
    llm = ContentKeyedLLM(json.loads(json.dumps(script)))
    finals = pkg["batch_driver"].LockstepPipeline(
        ocr, llm, quiet=True).run_many(states)
    return [comparable(f) for f in finals], ocr.batch_sizes, llm.calls


@pytest.mark.parametrize("name", sorted(LOCKSTEP))
def test_run_many_matches_jax(name):
    got = run_lockstep(PORT, *LOCKSTEP[name])
    assert got == run_lockstep(JAX, *LOCKSTEP[name])
    assert all(f["status"] in ("completed", "max_iterations") for f in got[0])


def test_run_many_matches_single_page_runs():
    """Per page, the lockstep schedule ends where the single-page driver
    does (same state apart from the trace's interleaving of pages)."""
    strategies, max_iter, reads, script = LOCKSTEP["mixed"]
    locked, _, _ = run_lockstep(PORT, strategies, max_iter, reads, script)
    cfg = config.RunConfig(strategies=strategies)
    for final in locked:
        path = final["image_path"]
        page_reads = {k: v for k, v in reads.items() if k[0] == path}
        solo = driver.OCRPipeline(
            PageKeyedOCR(page_reads),
            ContentKeyedLLM(json.loads(json.dumps(script))), quiet=True).run(
            state.initial_state(path, config=cfg.as_state_dict(),
                                max_iterations=max_iter))
        solo = comparable(solo)
        for key in ("status", "reason", "iteration", "current_best",
                    "strategies_used", "plateau_count", "current_score"):
            assert solo[key] == final[key]
        assert [e["action"] for e in solo["trace_events"]] == \
            [e["action"] for e in final["trace_events"]]


# ── state and trace ─────────────────────────────────────────────────

def test_state_and_trace_match_jax(tmp_path, capsys):
    args = dict(config={"accept_threshold": 85}, max_iterations=3,
                start_time=0.0)
    assert state.initial_state("/p.png", **args) == \
        jax_state.initial_state("/p.png", **args)
    s = state.initial_state("/p.png", **args)
    event = state.trace_log(s, iteration=1, agent="critic", action="critique",
                            input_summary="in", output_summary="out",
                            metrics={"n": 1}, decision="accept")
    want = jax_state.trace_log(s, iteration=1, agent="critic",
                               action="critique", input_summary="in",
                               output_summary="out", metrics={"n": 1},
                               decision="accept")
    assert comparable({"trace_events": [event]}) == \
        comparable({"trace_events": [want]})
    # "[MM:SS] out": minutes since start_time (monotonic 0.0 here, so the
    # minutes field widens with the host's uptime)
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == 2
    assert all(re.fullmatch(r"\[\d{2,}:\d{2}\] out", line) for line in printed)
    events = [dict(event, elapsed_seconds=65.0)]
    for name, module in (("port", trace), ("jax", jax_trace)):
        t = module.Trace.from_events(events)
        t.save_json(tmp_path / name / "trace.json")
        t.save_summary(tmp_path / name / "summary.txt")
    for file in ("trace.json", "summary.txt"):
        assert (tmp_path / "port" / file).read_bytes() == \
            (tmp_path / "jax" / file).read_bytes()


def test_profile_span_names_a_host_span():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.profile_span("node:critic"):
            torch.ones(4).sum()
    assert "node:critic" in {e.key for e in prof.key_averages()}


# ── one rendered page through tiny real engines ─────────────────────

@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    from torch_port_tiny import SMALL_TOKENIZER, configs, jax_tree, port_tree
    from handwritten_ocr_tpu.engine.jax_engines import (JaxOCRBackend,
                                                        JaxReasoningBackend,
                                                        TPUPreprocessor)
    from handwritten_ocr_tpu.models.init import init_qwen3 as jax_init_qwen3
    from handwritten_ocr_tpu.models.qwen25vl.model import (
        VLModel as JaxVLModel)
    from handwritten_ocr_tpu.models.qwen3 import (
        Qwen3Config as JaxQwen3Config, Qwen3Model as JaxQwen3Model)
    from handwritten_ocr_tpu_torch.engine.torch_engines import (
        TorchOCRBackend, TorchPreprocessor, TorchReasoningBackend)
    from handwritten_ocr_tpu_torch.models.qwen25vl.model import VLModel
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model
    from handwritten_ocr_tpu_torch.models.weights import from_jax_params
    from test_torch_guided import TINY

    tok = SMALL_TOKENIZER
    ids = tok.SPECIALS
    jax_cfg, port_cfg = configs(
        vocab_size=300, image_token_id=ids["<|image_pad|>"], video_token_id=299,
        vision_start_token_id=ids["<|vision_start|>"],
        vision_end_token_id=ids["<|vision_end|>"],
        eos_token_id=ids["<|im_end|>"], pad_token_id=0)
    vl_tree = jax.tree_util.tree_map(np.asarray, jax_tree(jax_cfg, seed=5))
    q_tree = jax.tree_util.tree_map(np.asarray, jax_init_qwen3(
        jax.random.PRNGKey(6), JaxQwen3Config(**TINY), dtype=jnp.float32))
    pixels = dict(min_pixels=28 * 28, max_pixels=84 * 84)
    rng = np.random.default_rng(9)
    page = np.clip(rng.normal(235, 8, (70, 80, 3)), 180, 255)
    for _ in range(6):
        y, x = int(rng.integers(5, 60)), int(rng.integers(2, 50))
        page[y:y + 3, x:x + int(rng.integers(12, 25))] = rng.integers(10, 60)
    path = str(tmp_path_factory.mktemp("page") / "page.png")
    Image.fromarray(page.astype(np.uint8)).save(path)
    jax_side = (JaxOCRBackend(JaxVLModel(vl_tree, jax_cfg), tok, **pixels),
                JaxReasoningBackend(JaxQwen3Model(q_tree,
                                                  JaxQwen3Config(**TINY)), tok),
                TPUPreprocessor(**pixels))
    port_side = (TorchOCRBackend(VLModel(port_tree(vl_tree), port_cfg), tok,
                                 device="cpu", kv_quant=False, **pixels),
                 TorchReasoningBackend(Qwen3Model(from_jax_params(q_tree),
                                                  Qwen3Config(**TINY)), tok,
                                       device="cpu", kv_quant=False),
                 TorchPreprocessor(device="cpu", **pixels))
    return path, {"jax": jax_side, "port": port_side}


def _real_run(pkg, side, path, lockstep: bool):
    ocr, llm, prep = side
    cfg = config.RunConfig(max_iterations=2, ocr_max_new_tokens=6,
                           llm_max_tokens=40)
    s = pkg["state"].initial_state(path, config=cfg.as_state_dict(),
                                   max_iterations=cfg.max_iterations)
    if lockstep:
        [final] = pkg["batch_driver"].LockstepPipeline(
            ocr, llm, preprocessor=prep, quiet=True).run_many([s])
    else:
        final = pkg["driver"].OCRPipeline(ocr, llm, preprocessor=prep,
                                          quiet=True).run(s)
    final = comparable(final)
    return dict(transcription=final["current_best"], reason=final["reason"],
                iteration=final["iteration"], status=final["status"],
                candidates=[c["text"] for c in final["candidates"]],
                critiques=final["critiques"],
                actions=[e["action"] for e in final["trace_events"]])


@pytest.mark.parametrize("lockstep", [False, True],
                         ids=["OCRPipeline", "LockstepPipeline"])
def test_real_engines_match_jax(engines, lockstep):
    path, sides = engines
    with jax.default_matmul_precision("highest"):
        want = _real_run(JAX, sides["jax"], path, lockstep)
    got = _real_run(PORT, sides["port"], path, lockstep)
    assert got == want
    assert got["status"] in ("completed", "max_iterations")
    assert got["actions"][:2] == ["preprocess", "ocr"]
