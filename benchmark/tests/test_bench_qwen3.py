"""The agent cell's reference and its inputs against the port, on the
CPU: the plain Qwen3 forward against ``Qwen3Model.forward_logits`` on
the benchmark's own weights (as drawn, and int8 as served), the
benchmark's int8 rounding against the port's, the chat prompt and the
tokenizer against the port's, and the choice check's copy of the schema
session's scans against the session itself."""

import numpy as np
import pytest
import torch

import tiny_agents
from benchmark import choices, qwen3_weights
from benchmark.reference import models as rm
from benchmark.reference import qwen3 as rq
from benchmark.reference.chat import DenseTokenizer, chat_prompt

CPU = torch.device("cpu")


def tiny_config():
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Config
    return Qwen3Config.from_hf(tiny_agents.TEXT)


@pytest.mark.parametrize("served", ["as_drawn", "int8"])
def test_the_reference_is_the_port_s_forward(served):
    """The port's fp32 forward over the benchmark's weights (drawn in fp32,
    or served: int8 by ``quantize_tree`` and widened) against the plain
    reference over the same units drawn again from the seed."""
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Model
    cfg = tiny_config()
    units = qwen3_weights.units(cfg)
    std = tiny_agents.tiny.INIT_STD
    if served == "int8":
        params = _widened(qwen3_weights.program_params(units, 7, CPU,
                                                       std=std))

        def unit(name):
            return qwen3_weights.reference_unit(units, name, 7, CPU, std)
    else:
        def unit(name):
            index = qwen3_weights.unit_index(units, name)
            return qwen3_weights.draw(units[index][1], 7, index, CPU,
                                      torch.float32, std)
        params = {"embed": unit("text.embed"),
                  "layers": [unit(f"text.layer.{i}")
                             for i in range(cfg.num_hidden_layers)],
                  "final_norm": unit("text.final_norm"),
                  "lm_head": unit("text.lm_head")}
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size, 40)
    port = Qwen3Model(params, cfg).forward_logits(ids[None])[0]
    rm.full_fp32()
    ref = rq.logits(unit, cfg, [{"ids": ids, "want": list(range(40))}],
                    CPU)[0]
    assert float((port - ref).abs().max()) < 1e-5 * float(ref.abs().max())


def _widened(tree):
    """A served tree in fp32: int8 projections widened, bf16 leaves cast."""
    if isinstance(tree, list):
        return [_widened(v) for v in tree]
    if isinstance(tree, dict):
        if "w_q" in tree:
            return {"w": tree["w_q"].float() * tree["w_scale"][:, None]}
        return {k: _widened(v) for k, v in tree.items()}
    return tree.float()


@pytest.mark.parametrize("levels", [127, 7])
def test_the_benchmark_s_rounding_is_the_port_s(levels):
    from handwritten_ocr_tpu_torch.models.quant import quantize_tree
    w = torch.randn(96, 160, generator=torch.Generator().manual_seed(5))
    w[3] = 0                                   # an all-zero channel
    w = (w * 0.02).to(torch.bfloat16)
    w_q, scale = qwen3_weights.round_int(w, levels)
    if levels == 127:
        port = quantize_tree({"q": {"w": w}})["q"]
        assert torch.equal(w_q, port["w_q"])
        assert torch.equal(scale, port["w_scale"])
    assert int(w_q.abs().max()) == levels
    assert torch.equal(scale, w.float().abs().amax(-1).clamp_min(1e-8)
                       / levels)


def test_the_program_gets_quantize_tree_s_weights_and_the_reference_them():
    cfg = tiny_config()
    units = qwen3_weights.units(cfg)
    served = qwen3_weights.program_params(units, 11, CPU)
    layer = served["layers"][1]
    assert set(layer["attn"]) == {"q", "k", "v", "o", "q_norm", "k_norm"}
    assert layer["attn"]["q"]["w_q"].dtype == torch.int8
    assert layer["attn"]["q_norm"]["scale"].dtype == torch.bfloat16
    assert served["embed"]["w"].dtype == torch.bfloat16
    assert served["lm_head"]["w_q"].shape == (cfg.vocab_size, cfg.hidden_size)
    ref = qwen3_weights.reference_unit(units, "text.layer.1", 11, CPU)
    widened = layer["attn"]["o"]["w_q"].float() \
        * layer["attn"]["o"]["w_scale"][:, None]
    assert torch.equal(ref["attn"]["o"]["w"], widened)
    head = qwen3_weights.reference_unit(units, "text.lm_head", 11, CPU)
    assert torch.equal(head["w"], served["lm_head"]["w_q"].float()
                       * served["lm_head"]["w_scale"][:, None])
    control = qwen3_weights.program_params(units, 11, CPU, levels=7)
    assert int(control["layers"][0]["mlp"]["up"]["w_q"].abs().max()) == 7


def test_the_prompt_and_the_tokenizer_are_the_port_s():
    from handwritten_ocr_tpu_torch.agents.runners import critic_request
    from handwritten_ocr_tpu_torch.models.processor import (ByteTokenizer,
                                                            llm_chat_prompt)
    turn = critic_request("the letter was written in march\nand sent")
    text = chat_prompt(turn.system, turn.user)
    assert text == llm_chat_prompt(turn.system, turn.user)
    ids = DenseTokenizer().encode(text + "é€<|image_pad|>")
    assert ids == ByteTokenizer().encode(text + "é€<|image_pad|>")
    assert DenseTokenizer().decode([65, 65 + 256, 151645]) == "AA]"


def test_the_copied_scan_decides_as_the_session_does():
    """At every choice of a critic answer, for many orders of candidate
    ids, the token ``decider`` finds commits what the session commits."""
    from handwritten_ocr_tpu_torch.agents.schemas import CriticResult
    from handwritten_ocr_tpu_torch.utils.schema_decode import compile_schema
    tok, eos = DenseTokenizer(), 151645
    spec = compile_schema(CriticResult.json_schema())
    text = ('{"overall_confidence": 42, "segments": [{"text": "a", '
            '"confidence": 7, "issues": [{"description": "b", "severity": '
            '"minor", "suggestion": "c"}]}], "verdict": "accept", '
            '"reasoning": "d"}')
    # the session is done at the last value's closing quote: the closing
    # brace is never committed
    tokens = tok.encode(text)[:-1]
    states, mismatches = choices.walk(tokens, {}, spec, tok, eos, 256)
    assert mismatches == 0
    at = [i for i, s in enumerate(states) if isinstance(s, tuple)]
    kinds = [states[i][0] for i in at]
    assert kinds.count("enum") == 2 and kinds.count("decision") == 4
    assert kinds.count("integer") == 5          # 4, 2, stop; 7, stop
    rng = np.random.default_rng(0)
    pool = np.concatenate([np.arange(32, 127), [eos, 10, 9],
                           rng.integers(0, 151936, 300)])
    for i in at:
        for _ in range(40):
            order = rng.choice(pool, size=rng.integers(1, 12), replace=False)
            pick = choices.reference_pick(tokens, {}, i, order, spec, tok,
                                          eos, 256)
            token = choices.decider(states[i], order, tok.decode, eos)
            if token is None or token == eos:
                continue          # the default: the session forces it
            expect = choices.reference_pick(tokens, {}, i, [token], spec,
                                            tok, eos, 256)
            assert pick == expect, (i, states[i], order.tolist())
