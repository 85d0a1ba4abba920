"""Schema-guided decode: the port's ``ContinuousBatcher.run_guided`` and
``TorchReasoningBackend.chat`` / ``chat_batch(json_schema=...)`` against
the JAX package's, on the same tiny fp32 Qwen3.

The weights are drawn by the JAX ``init_qwen3`` and carried over; both
sides decode over full-precision KV (the JAX backend's CPU cache). The
tokenizer is ``torch_port_tiny.SmallTokenizer`` (the special ids at
256-262, one character per id): random weights then write digits, quotes
and braces, and the guided sessions take every path (integers, enums,
array decisions, string spans). One tokenizer object serves both sides.

Committed tokens are compared through a session subclass that records
what each session commits; the objects, ``complete`` flags and committed
tokens must be equal per request.
"""

import json
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handwritten_ocr_tpu.engine import serving as jax_serving
from handwritten_ocr_tpu.engine.jax_engines import JaxReasoningBackend
from handwritten_ocr_tpu.models.init import init_qwen3 as jax_init_qwen3
from handwritten_ocr_tpu.models.processor import (
    ByteTokenizer as JaxByteTokenizer)
from handwritten_ocr_tpu.models.qwen3 import (Qwen3Config as JaxQwen3Config,
                                              Qwen3Model as JaxQwen3Model)
from handwritten_ocr_tpu.utils import schema_decode as jax_schema_decode
from handwritten_ocr_tpu_torch.agents.schemas import (ArbitratorResult,
                                                      CriticResult,
                                                      EditorResult)
from handwritten_ocr_tpu_torch.engine import serving
from handwritten_ocr_tpu_torch.engine.step_graph import StepGraphs
from handwritten_ocr_tpu_torch.engine.torch_engines import TorchReasoningBackend
from handwritten_ocr_tpu_torch.models.processor import ByteTokenizer
from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model
from handwritten_ocr_tpu_torch.models.weights import from_jax_params
from handwritten_ocr_tpu_torch.utils import schema_decode
from torch_port_tiny import SMALL_TOKENIZER as TOKENIZER

torch.set_num_threads(1)

EOS = TOKENIZER.SPECIALS["<|im_end|>"]
TINY = dict(vocab_size=300, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            head_dim=16, eos_token_id=EOS, pad_token_id=0)
BATCHER = dict(n_slots=2, block_size=8, max_context=160, prefill_bucket=16)
CONTRACTS = [CriticResult, EditorResult, ArbitratorResult]


class Turn:
    def __init__(self, system, user):
        self.system, self.user = system, user


TURNS = [Turn("You are a critic.", "Check: teh cat sat on teh mat"),
         Turn("sys", "a much longer user message that lands in another "
                     "prefill bucket than the first one does"),
         Turn("x", "y")]


@pytest.fixture(scope="module")
def tree():
    tree = jax_init_qwen3(jax.random.PRNGKey(2), JaxQwen3Config(**TINY),
                          dtype=jnp.float32)
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def programs(tree):
    """(JAX program, port program) on the same weights; one JAX program
    per module, so its compiled steps serve every case."""
    return (jax_serving.PagedProgram(tree, JaxQwen3Config(**TINY)),
            serving.PagedProgram(from_jax_params(tree), Qwen3Config(**TINY)))


def recording(session_cls, log: list):
    """``session_cls`` whose instances append what they commit (each
    returned token, each absorbed string row) to a list in ``log``."""

    class Recording(session_cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.committed: list[int] = []
            log.append(self.committed)

        def next_token(self, top_ids):
            token = super().next_token(top_ids)
            if token is not None:
                self.committed.append(int(token))
            return token

        def absorb_string_tokens(self, tokens):
            self.committed.extend(int(t) for t in tokens)
            super().absorb_string_tokens(tokens)

    return Recording


def prompts():
    rng = np.random.default_rng(4)
    return [(rng.integers(0, 256, n).astype(np.int32), budget)
            for n, budget in ((5, 40), (11, 24), (19, 56))]


@pytest.mark.parametrize("chunk", [1, 16])
@pytest.mark.parametrize("contract", CONTRACTS, ids=lambda c: c.__name__)
def test_run_guided_matches_jax(programs, contract, chunk, monkeypatch):
    """Three requests through two slots (admission, retirement, string
    chunks of 1 and 16 steps): per request the same object, complete flag
    and committed tokens as the JAX batcher; the port's requests carry
    their committed tokens."""
    schema = contract.json_schema()
    jax_log, port_log = [], []
    monkeypatch.setattr(jax_schema_decode, "SchemaSession",
                        recording(jax_schema_decode.SchemaSession, jax_log))
    monkeypatch.setattr(schema_decode, "SchemaSession",
                        recording(schema_decode.SchemaSession, port_log))
    with jax.default_matmul_precision("highest"):
        jax_batcher = jax_serving.ContinuousBatcher(
            programs[0], dtype=jnp.float32, chunk=chunk, **BATCHER)
        want = jax_batcher.run_guided(
            [jax_serving.GenRequest(ids, budget) for ids, budget in prompts()],
            schema, TOKENIZER)
    batcher = serving.ContinuousBatcher(
        programs[1], dtype=torch.float32, device="cpu", chunk=chunk, **BATCHER)
    requests = [serving.GenRequest(ids, budget) for ids, budget in prompts()]
    got = batcher.run_guided(requests, schema, TOKENIZER)
    assert got == want
    assert port_log == jax_log
    assert sorted(r.tokens for r in requests) == sorted(port_log)
    for obj, complete in got:
        assert complete
        contract.validate(obj)
    assert batcher.stats["sessions"] == batcher.stats["sessions_complete"] == 3
    assert batcher.stats["guided_tokens"] == sum(map(len, port_log))
    assert len(batcher._free_slots) == 2
    assert len(batcher._free_blocks) == batcher.n_blocks - 1


def test_guided_paths_are_exercised(programs):
    """The parity cases above take both stepping disciplines (top-k steps
    and string chunks), integers with digits, and arrays with items
    (random weights, fixed seed)."""
    batcher = serving.ContinuousBatcher(
        programs[1], dtype=torch.float32, device="cpu", chunk=16, **BATCHER)
    got = batcher.run_guided(
        [serving.GenRequest(ids, budget) for ids, budget in prompts()],
        CriticResult.json_schema(), TOKENIZER)
    objects = [obj for obj, _ in got]
    assert any(obj["overall_confidence"] > 0 for obj in objects)
    assert any(obj["segments"] for obj in objects)
    assert batcher.stats["string_steps"] > 0 and batcher.stats["topk_steps"] > 0


class ReplayedOutputs(StepGraphs):
    """``StepGraphs`` without a card: a step runs its body eagerly, then
    returns one tensor per key that every later step of the key
    overwrites, as a graph's replay does; the first step of a key counts
    as its capture."""

    def step(self, key, step):
        out = step()
        counter = "decode" if key[0] == "greedy" else "guided"
        held = self._graphs.get(key)      # the output in place of a graph
        if held is None:
            self._graphs[key] = out
            self.stats[f"{counter}_graph_captures"] += 1
            return out
        held.copy_(out)
        self.stats[f"{counter}_graph_steps"] += 1
        return held


@pytest.mark.parametrize("chunk", [1, 16])
@pytest.mark.parametrize("contract", CONTRACTS, ids=lambda c: c.__name__)
def test_guided_steps_over_replayed_outputs_equal_eager(programs, contract,
                                                        chunk, monkeypatch):
    """Guided decode through graphs whose every replay writes the same
    output tensor, against the batcher stepping eagerly (as it does on
    the CPU): the same objects and committed tokens, and every top-k step's
    and string chunk's outputs, kept as the benchmark's recorder keeps
    them until the round ends, equal to the eager steps'. A step that
    handed out a graph's own buffer would read the last replay's ids."""
    program = programs[1]
    schema = contract.json_schema()
    runs = []
    for replayed in (False, True):
        kept = []
        for name in ("step_topk", "string_chunk"):
            def keep(*args, _original=getattr(type(program), name), **kw):
                out = _original(program, *args, **kw)
                kept.append(out)
                return out
            monkeypatch.setattr(program, name, keep)
        batcher = serving.ContinuousBatcher(
            program, dtype=torch.float32, device="cpu", chunk=chunk, **BATCHER)
        assert not batcher._graphs.captures
        if replayed:
            batcher._graphs = ReplayedOutputs(program, batcher.cache,
                                              batcher.stats)
        requests = [serving.GenRequest(ids, budget)
                    for ids, budget in prompts()]
        got = batcher.run_guided(requests, schema, TOKENIZER)
        runs.append((got, [r.tokens for r in requests], kept,
                     dict(batcher.stats)))
    (want, want_tokens, eager, eager_stats), (got, tokens, kept, stats) = runs
    assert got == want and tokens == want_tokens
    assert len(kept) == len(eager)
    for out, ref in zip(kept, eager):
        if isinstance(out, tuple):          # string_chunk's four outputs
            assert out[3] == ref[3]
            assert all(torch.equal(a, b) for a, b in zip(out[:3], ref[:3]))
        else:
            assert torch.equal(out, ref)
    assert eager_stats["guided_graph_steps"] == 0
    assert eager_stats["guided_graph_captures"] == 0
    steps = stats["topk_steps"] + stats["string_steps"]
    assert steps == eager_stats["topk_steps"] + eager_stats["string_steps"]
    assert stats["string_steps"] > 0 and stats["topk_steps"] > 0
    assert stats["guided_graph_captures"] >= 2
    assert stats["guided_graph_steps"] == steps - stats["guided_graph_captures"]
    assert stats["decode_graph_steps"] == stats["decode_graph_captures"] == 0


@pytest.mark.parametrize("unit", ["decode_chunk", "string_chunk",
                                  "step_topk"])
def test_a_step_unit_keeps_its_inputs_and_hands_out_copies(programs, unit):
    """A unit's caller keeps its inputs and outputs past the next step (the
    benchmark's ``instrument`` reads them after the call, its recorder
    keeps every top-k until the round ends): each step unit leaves its
    input tensors as they were and returns tensors that share no memory
    with the batcher's step buffers, and a later step, whose replay
    writes the same output tensor, changes none of them."""
    program = programs[1]
    batcher = serving.ContinuousBatcher(program, dtype=torch.float32,
                                        device="cpu", **BATCHER)
    batcher._graphs = graphs = ReplayedOutputs(program, batcher.cache,
                                               batcher.stats)
    batcher._prefill_admitted(batcher._try_admit(deque(
        serving.GenRequest(ids, budget) for ids, budget in prompts()[:2])))
    live = torch.ones((batcher.n_slots,), dtype=torch.bool)
    remaining = torch.full((batcher.n_slots,), 3, dtype=torch.int32)
    rope = torch.zeros((batcher.n_slots,), dtype=torch.int32)
    stop = torch.zeros((TINY["vocab_size"],), dtype=torch.bool)

    def call(last):
        args = {"decode_chunk": (last, ~live, remaining, rope, 4),
                "string_chunk": (last, live, remaining, stop, rope, 4),
                "step_topk": (last, live, rope, 5)}[unit]
        inputs = [a for a in args if isinstance(a, torch.Tensor)]
        before = [t.clone() for t in inputs]
        out = getattr(program, unit)(batcher.cache, *args, graphs=graphs)
        assert all(torch.equal(t, b) for t, b in zip(inputs, before))
        return [t for t in (out if isinstance(out, tuple) else (out,))
                if isinstance(t, torch.Tensor)]

    outputs = call(torch.as_tensor(batcher._last))
    kept = [t.clone() for t in outputs]
    buffers = [graphs.last, graphs.live, graphs.rope_delta, graphs.slot_ids,
               *graphs._graphs.values()]
    assert len(graphs._graphs) == 1
    for out in outputs:
        assert all(out.untyped_storage().data_ptr()
                   != buf.untyped_storage().data_ptr() for buf in buffers)
    call(torch.as_tensor(batcher._last) + 1)
    assert all(torch.equal(t, k) for t, k in zip(outputs, kept))


@pytest.fixture(scope="module")
def backends(tree):
    """(JAX backend, port backend), kept for the module: their batchers
    (and the JAX compiled steps) serve every chat case."""
    return (JaxReasoningBackend(JaxQwen3Model(tree, JaxQwen3Config(**TINY)),
                                TOKENIZER, serving="paged"),
            TorchReasoningBackend(
                Qwen3Model(from_jax_params(tree), Qwen3Config(**TINY)),
                TOKENIZER, device="cpu", kv_quant=False))


@pytest.mark.parametrize("contract", CONTRACTS, ids=lambda c: c.__name__)
def test_chat_batch_and_chat_match_jax(backends, contract):
    schema = contract.json_schema()
    jax_side, port = backends
    with jax.default_matmul_precision("highest"):
        want = jax_side.chat_batch(TURNS, temperature=0.1, max_tokens=48,
                                   json_schema=schema)
        want_one = jax_side.chat(TURNS[1].system, TURNS[1].user,
                                 temperature=0.1, max_tokens=48,
                                 json_schema=schema)
    got = port.chat_batch(TURNS, temperature=0.1, max_tokens=48,
                          json_schema=schema)
    assert got == want
    for text in got:
        contract.validate(json.loads(text))
    assert port.chat(TURNS[1].system, TURNS[1].user, temperature=0.1,
                     max_tokens=48, json_schema=schema) == want_one


def test_incomplete_sessions_fall_back_to_free_decode(backends):
    """A schema whose required field comes after a string: at a tiny
    budget the string spends it, the session is not complete, and chat /
    chat_batch answer those rows by free decode, as JAX does."""
    schema = {"properties": {"note": {"type": "string", "title": "Note"},
                             "answer": {"type": "string", "title": "Answer"}},
              "required": ["answer"], "title": "Late", "type": "object"}
    jax_side, port = backends
    with jax.default_matmul_precision("highest"):
        want = jax_side.chat_batch(TURNS[:2], temperature=0.1, max_tokens=12,
                                   json_schema=schema)
        want_one = jax_side.chat("s", "u", temperature=0.1, max_tokens=12,
                                 json_schema=schema)
    before = dict(port._batcher.stats) if port._batcher else {}
    got = port.chat_batch(TURNS[:2], temperature=0.1, max_tokens=12,
                          json_schema=schema)
    assert got == want
    stats = port._batcher.stats
    assert stats["sessions"] - before.get("sessions", 0) == 2
    assert stats["sessions_complete"] == before.get("sessions_complete", 0)
    assert port.chat("s", "u", temperature=0.1, max_tokens=12,
                     json_schema=schema) == want_one


# Kept for the module's life: the JAX package caches stop masks by
# id(tokenizer), which a freed tokenizer's successor could reuse.
BYTE_TOKENIZERS = (ByteTokenizer(), JaxByteTokenizer())


@pytest.mark.parametrize("tokenizer", ["byte", "small"])
def test_stop_mask_matches_jax(tokenizer):
    if tokenizer == "byte":
        (port_tok, jax_tok), vocab, eos = BYTE_TOKENIZERS, 152064, 151645
    else:
        port_tok = jax_tok = TOKENIZER
        vocab, eos = 300, EOS
    got = serving._string_stop_mask(port_tok, vocab, eos)
    want = jax_serving._string_stop_mask(jax_tok, vocab, eos)
    np.testing.assert_array_equal(got, want)
    assert got[eos] and got[ord('"')]
    assert serving._string_stop_mask(port_tok, vocab, eos) is got   # cached


def test_topk_ties_come_out_index_ascending():
    """Deliberate ties (a whole row equal, ties straddling the k-th place,
    negative zeros and infinities elsewhere): the ids are value-descending
    and index-ascending on ties, as ``jax.lax.top_k`` gives them."""
    rng = np.random.default_rng(0)
    logits = rng.integers(-3, 4, (6, 300)).astype(np.float32)
    logits[0] = 1.5
    logits[1, [7, 3, 250]] = 9.0
    logits[2] = rng.normal(size=300).astype(np.float32)
    logits[2, [5, 6, 100]] = -np.inf
    logits[3, ::2] = np.float32(1e-30)
    logits[4] = -logits[4]
    k = 64
    got = serving.topk_ids(torch.from_numpy(logits), k).numpy()
    want = np.argsort(-logits, axis=-1, kind="stable")[:, :k]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jax.lax.top_k(jnp.asarray(logits), k)[1]))
