"""Prompt-lookup speculative decoding: the port's ``_ngram_draft``,
``PagedProgram.verify_step``, ``ContinuousBatcher.run`` with speculating
requests and ``run_guided``'s verify rounds against the JAX package's, on
the same tiny fp32 Qwen3.

The weights are drawn by the JAX ``init_qwen3`` and carried over with
``from_jax_params``; inputs come from a numpy seed. On the CPU the verify
forward and the decode step round alike, so speculation must leave every
greedy token unchanged: tokens are compared for equality, with the JAX
package's speculative runs and with the port's own plain runs.
``spec_stats`` (rounds, drafted, accepted) must equal the JAX batcher's.
"""

from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handwritten_ocr_tpu.engine import serving as jax_serving
from handwritten_ocr_tpu.engine.jax_engines import JaxReasoningBackend
from handwritten_ocr_tpu.models.init import init_qwen3 as jax_init_qwen3
from handwritten_ocr_tpu.models.qwen3 import (Qwen3Config as JaxQwen3Config,
                                              Qwen3Model as JaxQwen3Model)
from handwritten_ocr_tpu_torch.agents.schemas import (ArbitratorResult,
                                                      EditorResult)
from handwritten_ocr_tpu_torch.engine import serving
from handwritten_ocr_tpu_torch.engine.torch_engines import TorchReasoningBackend
from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model
from handwritten_ocr_tpu_torch.models.weights import from_jax_params
from torch_port_tiny import SMALL_TOKENIZER as TOKENIZER

torch.set_num_threads(1)

EOS = TOKENIZER.SPECIALS["<|im_end|>"]
TINY = dict(vocab_size=300, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            head_dim=16, eos_token_id=EOS, pad_token_id=0)
BATCHER = dict(n_slots=2, block_size=8, max_context=192, chunk=5,
               prefill_bucket=16)


@pytest.fixture(scope="module")
def tree():
    tree = jax_init_qwen3(jax.random.PRNGKey(5), JaxQwen3Config(**TINY),
                          dtype=jnp.float32)
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def programs(tree):
    """(JAX program, port program) on the same weights."""
    return (jax_serving.PagedProgram(tree, JaxQwen3Config(**TINY)),
            serving.PagedProgram(from_jax_params(tree), Qwen3Config(**TINY)))


def batchers(programs, **kw):
    """(JAX batcher, port batcher) of the same shape, fp32 pools unless
    ``kv_quant``."""
    kw = {**BATCHER, **kw}
    return (jax_serving.ContinuousBatcher(programs[0], dtype=jnp.float32,
                                          **kw),
            serving.ContinuousBatcher(programs[1], dtype=torch.float32,
                                      device="cpu", **kw))


# ── _ngram_draft ──────────────────────────────────────────────────────

def _draft_cases():
    """The JAX package's cases, then contexts drawn from small alphabets
    (so n-grams recur) at several lengths and draft widths."""
    cases = [([5, 6, 7, 8, 9, 1, 2, 5, 6, 7], 3),
             ([5, 6, 7, 8, 9, 1, 2, 5, 6, 7], 8),
             (list(range(10)), 4),
             ([1, 2, 3, 1, 2, 4, 1, 2], 2),
             ([], 4), ([3], 4), ([3, 3], 4), ([3, 3, 3], 4)]
    rng = np.random.default_rng(0)
    for alphabet in (2, 3, 5, 9):
        for length in (4, 17, 60):
            for k in (1, 6, 16):
                cases.append((rng.integers(0, alphabet, length).tolist(), k))
    return cases


@pytest.mark.parametrize("context,k", _draft_cases())
def test_ngram_draft_matches_jax(context, k):
    context = np.asarray(context, np.int32)
    want = jax_serving._ngram_draft(context, k)
    got = serving._ngram_draft(context, k)
    assert got.dtype == np.int32
    assert got.tolist() == want.tolist()


# ── verify_step ───────────────────────────────────────────────────────

def _greedy(programs, prompt, n):
    """The port's plain greedy continuation of ``prompt``: n tokens."""
    batcher = serving.ContinuousBatcher(programs[1], dtype=torch.float32,
                                        device="cpu", **BATCHER)
    [tokens] = batcher.run([serving.GenRequest(prompt, n)])
    return tokens


@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp_kv", "int8_kv"])
def test_verify_step_matches_jax(tree, kv_quant, monkeypatch):
    """Three slots after their prefill: slot 0 drafts the greedy
    continuation (every draft accepted), slot 1 the same with a wrong
    token at draft 3 (3 accepted), slot 2 is inactive. Tokens up to each
    slot's bonus token, ``accepted``, the new lengths and the pool rows
    below them equal the JAX package's (int8 rows bit-equal; their fp32
    scales within 1e-6 relative and fp32 rows within 1e-5: the
    projections are the same sums in another order); an inactive
    slot keeps its length and appends nothing. The JAX prefill runs its
    flash kernel in the Pallas interpreter, so that both sides' prefill
    attends over full-precision k/v; its programs are built here, so no
    other test reuses what they trace."""
    monkeypatch.setenv("HOCR_TPU_FLASH", "interpret")
    programs = (jax_serving.PagedProgram(tree, JaxQwen3Config(**TINY)),
                serving.PagedProgram(from_jax_params(tree),
                                     Qwen3Config(**TINY)))
    k = 6
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (9, 14, 5)]
    jax_b, port_b = batchers(programs, n_slots=3, kv_quant=kv_quant)
    for batcher, make in ((jax_b, jax_serving.GenRequest),
                          (port_b, serving.GenRequest)):
        admitted = batcher._try_admit(deque(make(p, 40) for p in prompts))
        with jax.default_matmul_precision("highest"):
            batcher._prefill_admitted(admitted)
    assert np.array_equal(jax_b._last, port_b._last)
    greedy = [_greedy(programs, p, k + 1) for p in prompts[:2]]
    drafts = np.zeros((3, k), np.int32)
    drafts[0], drafts[1] = greedy[0][1:], greedy[1][1:]
    drafts[1, 3] = (drafts[1, 3] + 1) % 256
    draft_len = np.array([k, k, 0], np.int32)
    active = np.array([True, True, False])
    rope_delta = np.zeros(3, np.int32)
    cache = port_b.cache
    length2 = cache.lengths[2].item()
    inactive_rows = cache.k[:, cache.block_tables[2].long()].clone()
    with jax.default_matmul_precision("highest"):
        want_tokens, want_acc, jax_cache = jax_b.program.verify_step(
            jax_b.cache, jnp.asarray(jax_b._last), jnp.asarray(drafts),
            jnp.asarray(draft_len), jnp.asarray(active),
            jnp.asarray(rope_delta))
    tokens, accepted = port_b.program.verify_step(
        cache, torch.as_tensor(port_b._last), torch.as_tensor(drafts),
        torch.as_tensor(draft_len), torch.as_tensor(active),
        torch.as_tensor(rope_delta))
    want_acc = np.asarray(want_acc)
    assert accepted.tolist() == want_acc.tolist() == [k, 3, 0]
    for slot in (0, 1):
        n = want_acc[slot] + 1
        assert (tokens[slot, :n].tolist()
                == np.asarray(want_tokens)[slot, :n].tolist())
    assert tokens[0, :k].tolist() == greedy[0][1:]
    lengths = cache.lengths.tolist()
    assert lengths == np.asarray(jax_cache.lengths).tolist()
    assert lengths == [len(prompts[0]) + 1 + k, len(prompts[1]) + 4, length2]
    # (port pool, JAX pool, tolerance): None = bit-equal
    pools = [(cache.k, jax_cache.k, None if kv_quant else dict(atol=1e-5)),
             (cache.v, jax_cache.v, None if kv_quant else dict(atol=1e-5))]
    if kv_quant:
        pools += [(scale.transpose(2, 3), jax_scale.transpose(0, 1, 3, 2),
                   dict(rtol=1e-6))
                  for scale, jax_scale in ((cache.k_scale, jax_cache.k_scale),
                                           (cache.v_scale, jax_cache.v_scale))]
    for slot in range(3):
        table = cache.block_tables[slot].long()
        for pool, jax_pool, tol in pools:
            got = pool[:, table].reshape(pool.shape[0], -1, *pool.shape[3:])
            want = np.asarray(jax_pool)[:, table.numpy()].reshape(got.shape)
            got, want = got[:, :lengths[slot]].numpy(), want[:, :lengths[slot]]
            if tol is None:
                assert np.array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, **{"rtol": 0, **tol})
    assert torch.equal(cache.k[:, cache.block_tables[2].long()],
                       inactive_rows)


# ── run: free decode ──────────────────────────────────────────────────

def _oracle_prompts():
    rng = np.random.default_rng(3)
    base = rng.integers(1, 250, size=6)
    return ([np.tile(base, 5).astype(np.int32),
             rng.integers(1, 250, size=23).astype(np.int32),
             np.tile(rng.integers(1, 250, size=4), 8).astype(np.int32)],
            [20, 14, 17])


@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp_kv", "int8_kv"])
def test_run_with_oracle_drafts_matches_jax_and_plain(programs, kv_quant):
    """Drafts read from the plain greedy continuation (``draft_oracle``):
    on the CPU every draft is accepted, and the tokens equal the plain
    run's and the JAX package's speculative run's; ``spec_stats`` equal
    JAX's."""
    prompts, budgets = _oracle_prompts()
    jax_b, port_b = batchers(programs, draft_k=6, kv_quant=kv_quant)
    plain = port_b.run([serving.GenRequest(p, b)
                        for p, b in zip(prompts, budgets)])
    assert port_b.spec_stats["rounds"] == 0
    with jax.default_matmul_precision("highest"):
        want = jax_b.run([jax_serving.GenRequest(
            p, b, speculate=True, draft_oracle=np.asarray(t, np.int32))
            for p, b, t in zip(prompts, budgets, plain)])
    got = port_b.run([serving.GenRequest(
        p, b, speculate=True, draft_oracle=np.asarray(t, np.int32))
        for p, b, t in zip(prompts, budgets, plain)])
    assert got == plain == want
    assert port_b.spec_stats == jax_b.spec_stats
    assert port_b.spec_stats["rounds"] > 0
    assert port_b.spec_stats["accepted"] == port_b.spec_stats["drafted"]
    assert port_b.stats["verify_tokens"] > 0
    assert len(port_b._free_blocks) == port_b.n_blocks - 1


def test_prompt_lookup_mixed_with_plain_matches_jax(programs):
    """Prompt-lookup drafts (no oracle) beside a plain request, more
    requests than slots: the tokens equal the plain run's and JAX's, and
    ``spec_stats`` (rounds with rejected drafts, cooldowns) equal JAX's."""
    rng = np.random.default_rng(4)
    prompts = [np.tile(rng.integers(1, 250, size=5), 6).astype(np.int32),
               rng.integers(1, 250, size=11).astype(np.int32),
               np.tile(rng.integers(1, 250, size=3), 7).astype(np.int32)]
    flags = [True, False, True]
    jax_b, port_b = batchers(programs, draft_k=5)
    plain = port_b.run([serving.GenRequest(p, 15) for p in prompts])
    with jax.default_matmul_precision("highest"):
        want = jax_b.run([jax_serving.GenRequest(p, 15, speculate=f)
                          for p, f in zip(prompts, flags)])
    got = port_b.run([serving.GenRequest(p, 15, speculate=f)
                      for p, f in zip(prompts, flags)])
    assert got == plain == want
    assert port_b.spec_stats == jax_b.spec_stats
    assert port_b.spec_stats["rounds"] > 0


# ── run_guided: string verify rounds ──────────────────────────────────

def _copy_prompt(field: str) -> np.ndarray:
    """A prompt that holds the contract's opening scaffold and a
    repetitive page: inside the ``field`` span the suffix n-gram ``": "``
    recurs in the prompt, so prompt lookup drafts from it."""
    text = (f'fix: {{"{field}": "the cat sat. the cat sat. the cat sat.", '
            '"more": []} the cat sat. ')
    return np.asarray(TOKENIZER.encode(text), np.int32)


@pytest.mark.parametrize("contract,field", [(EditorResult, "corrected_text"),
                                            (ArbitratorResult, "final_text")],
                         ids=["editor", "arbitrator"])
def test_guided_speculation_matches_jax(programs, contract, field):
    """``run_guided`` with speculation off and on gives the same outcome
    (greedy-invisible; the committed tokens may differ only by the filler
    EOS a chunk row takes in when the budget stalls it), equal to JAX's
    with speculation on, with ``rounds > 0`` on the copy prompt and equal
    ``spec_stats``; three requests through two slots."""
    schema = contract.json_schema()
    prompts = [_copy_prompt(field), np.random.default_rng(6).integers(
        0, 256, 9).astype(np.int32), _copy_prompt(field)[:40]]
    outcomes, stats = [], []
    for speculate in (False, True):
        _, port_b = batchers(programs, draft_k=6, max_context=512, chunk=6)
        requests = [serving.GenRequest(p, 60, speculate=speculate)
                    for p in prompts]
        outcomes.append(port_b.run_guided(requests, schema, TOKENIZER))
        stats.append(dict(port_b.spec_stats))
        assert len(port_b._free_blocks) == port_b.n_blocks - 1
        assert port_b.stats["sessions_complete"] == 3
    assert outcomes[0] == outcomes[1]
    assert stats[0]["rounds"] == 0 and stats[1]["rounds"] > 0
    jax_b, _ = batchers(programs, draft_k=6, max_context=512, chunk=6)
    with jax.default_matmul_precision("highest"):
        want = jax_b.run_guided([jax_serving.GenRequest(p, 60, speculate=True)
                                 for p in prompts], schema, TOKENIZER)
    assert outcomes[1] == want
    assert stats[1] == jax_b.spec_stats


# ── the engine: HOCR_SPEC ─────────────────────────────────────────────

class Turn:
    def __init__(self, system, user):
        self.system, self.user = system, user


PAGE = 'the cat sat. the cat sat. the cat sat.'
TURNS = [Turn("Copy the page.", f'{{"corrected_text": "{PAGE}"}} {PAGE}'),
         Turn("sys", f'{{"corrected_text": "{PAGE[:20]}'),
         Turn("x", "y")]


def test_reasoning_backend_with_hocr_spec_matches_jax(tree, monkeypatch):
    """``HOCR_SPEC=1``: free and guided ``chat_batch`` give JAX's
    speculative texts and the port's own plain texts; unset, no verify
    round runs."""
    schema = EditorResult.json_schema()
    jax_side = JaxReasoningBackend(
        JaxQwen3Model(tree, JaxQwen3Config(**TINY)), TOKENIZER)
    port = TorchReasoningBackend(
        Qwen3Model(from_jax_params(tree), Qwen3Config(**TINY)), TOKENIZER,
        device="cpu", kv_quant=False)
    kw = dict(temperature=0.1, max_tokens=40)
    monkeypatch.delenv("HOCR_SPEC", raising=False)
    plain = (port.chat_batch(TURNS, **kw),
             port.chat_batch(TURNS, json_schema=schema, **kw))
    assert port._batcher.spec_stats["rounds"] == 0
    monkeypatch.setenv("HOCR_SPEC", "1")
    with jax.default_matmul_precision("highest"):
        want = (jax_side.chat_batch(TURNS, **kw),
                jax_side.chat_batch(TURNS, json_schema=schema, **kw))
    got = (port.chat_batch(TURNS, **kw),
           port.chat_batch(TURNS, json_schema=schema, **kw))
    assert got == want == plain
    assert port._batcher.spec_stats == jax_side._batcher.spec_stats
    assert port._batcher.spec_stats["rounds"] > 0
