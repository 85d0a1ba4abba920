"""KV pools planned for one card: the port's ``parallel/budget.py`` and the
engines' pools sized from it.

- The byte arithmetic (``*_param_bytes``, ``kv_cache_bytes``,
  ``coresident_plan``) equals the JAX package's ``parallel/budget.py`` for
  the published and the tiny configs, int8 and bf16: exact integers.
- A ``ContinuousBatcher`` with fewer blocks than slots x blocks per slot
  gives each request the tokens of a full pool, in free and in guided
  decode (exact token equality), and a request larger than the whole
  pool raises before anything runs.
- ``plan_pools`` hands each engine its component of one plan, and the
  engines' batchers hold no more blocks than their budgets.
"""

import numpy as np
import pytest
import torch

from handwritten_ocr_tpu.models.qwen25vl.config import VLConfig as JaxVLConfig
from handwritten_ocr_tpu.models.qwen3 import Qwen3Config as JaxQwen3Config
from handwritten_ocr_tpu.parallel import budget as jax_budget
from handwritten_ocr_tpu_torch import config as cfg_mod
from handwritten_ocr_tpu_torch.agents.schemas import CriticResult, EditorResult
from handwritten_ocr_tpu_torch.engine.serving import (ContinuousBatcher,
                                                      GenRequest, PagedProgram)
from handwritten_ocr_tpu_torch.engine.torch_engines import (
    TorchOCRBackend, TorchReasoningBackend, plan_pools)
from handwritten_ocr_tpu_torch.models.init import init_qwen3, init_vl
from handwritten_ocr_tpu_torch.models.paged import PagedKVCache
from handwritten_ocr_tpu_torch.models.qwen25vl.config import VLConfig
from handwritten_ocr_tpu_torch.models.qwen25vl.model import VLModel
from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model
from handwritten_ocr_tpu_torch.parallel import budget
from torch_port_tiny import SMALL_TOKENIZER as TOKENIZER
from torch_port_tiny import configs

torch.set_num_threads(1)

EOS = TOKENIZER.SPECIALS["<|im_end|>"]
TINY_QWEN3 = dict(vocab_size=300, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=16, eos_token_id=EOS,
                  pad_token_id=0)


def config_pairs():
    """(name, JAX VL, port VL, JAX Qwen3, port Qwen3)."""
    jax_tiny, port_tiny = configs()
    return [("published", JaxVLConfig(), VLConfig(), JaxQwen3Config(),
             Qwen3Config()),
            ("tiny", jax_tiny, port_tiny, JaxQwen3Config(**TINY_QWEN3),
             Qwen3Config(**TINY_QWEN3))]


@pytest.mark.parametrize("quant", ["int8", None])
@pytest.mark.parametrize("pair", config_pairs(), ids=lambda p: p[0])
def test_param_and_kv_bytes_match_jax(pair, quant):
    _, jvl, vl, jq, q = pair
    assert budget.vl_param_bytes(vl, quant) == jax_budget.vl_param_bytes(jvl, quant)
    assert (budget.qwen3_param_bytes(q, quant)
            == jax_budget.qwen3_param_bytes(jq, quant))
    for kv_quant in (True, False):
        args = (q.num_hidden_layers, 8, 4096, q.num_key_value_heads,
                q.head_dim)
        assert (budget.kv_cache_bytes(*args, kv_quant=kv_quant)
                == jax_budget.kv_cache_bytes(*args, kv_quant=kv_quant))


@pytest.mark.parametrize("quant", ["int8", None])
@pytest.mark.parametrize("chips", [dict(), dict(n_chips=1, hbm_per_chip=85 * 10**9)])
@pytest.mark.parametrize("pair", config_pairs(), ids=lambda p: p[0])
def test_coresident_plan_matches_jax(pair, chips, quant):
    _, jvl, vl, jq, q = pair
    want = jax_budget.coresident_plan(jvl, jq, quant=quant, **chips)
    got = budget.coresident_plan(vl, q, quant=quant, **chips)
    assert got.components == want.components
    assert (got.total_per_chip, got.fits) == (want.total_per_chip, want.fits)
    assert got.report() == want.report()


def test_card_plan_of_the_published_models():
    """One 80 GB H100 (85.0e9 bytes): olmOCR-2-7B in bf16 and qwen3:32b in
    int8, with the default pools and the activation reserve, fit; the
    full pools at the arbitrator's bound would not (pipeline_plan)."""
    vl, q = VLConfig(), Qwen3Config()
    plan = budget.coresident_plan(
        vl, q, n_chips=1, hbm_per_chip=85 * 10**9, vl_quant=None,
        llm_quant="int8", activation_reserve=cfg_mod.ACTIVATION_RESERVE_BYTES)
    assert plan.fits
    assert plan.component("vl_params[bf16]") == budget.vl_param_bytes(vl, None)
    assert plan.component("llm_kv") == budget.kv_cache_bytes(
        64, 8, 16384, 8, 128, kv_quant=True)
    full_llm_pools = (1 + cfg_mod.SERVE_SLOTS * 128) * PagedKVCache.block_bytes(
        64, 128, 8, 128, kv_quant=True)
    assert (plan.total_per_chip - plan.component("llm_kv") + full_llm_pools
            > 85 * 10**9)


def test_tree_bytes_and_block_bytes():
    cfg = Qwen3Config(**TINY_QWEN3)
    tree = init_qwen3(cfg, dtype=torch.bfloat16, device="cpu", quantize="int8")
    assert budget.tree_bytes(tree) == budget.qwen3_param_bytes(cfg, "int8")
    for kv_quant, dtype in ((True, torch.bfloat16), (False, torch.float32)):
        cache = PagedKVCache.zeros(2, 3, 8, 1, 1, 2, 16, dtype=dtype,
                                   kv_quant=kv_quant)
        pools = [cache.k, cache.v] + ([cache.k_scale, cache.v_scale]
                                      if kv_quant else [])
        assert 3 * PagedKVCache.block_bytes(2, 8, 2, 16, dtype, kv_quant) \
            == sum(p.numel() * p.element_size() for p in pools)


@pytest.fixture(scope="module")
def program():
    cfg = Qwen3Config(**TINY_QWEN3)
    return PagedProgram(init_qwen3(cfg, dtype=torch.float32, device="cpu",
                                   seed=3), cfg)


def _requests():
    rng = np.random.default_rng(5)
    return [GenRequest(rng.integers(0, 256, n).astype(np.int32), budget)
            for n, budget in ((5, 40), (30, 24), (9, 56), (17, 1), (3, 33),
                              (41, 20))]


def _batcher(program, n_blocks=None, kv_quant=False):
    return ContinuousBatcher(program, n_slots=4, block_size=8,
                             n_blocks=n_blocks, max_context=128, chunk=6,
                             prefill_bucket=16, dtype=torch.float32,
                             device="cpu", kv_quant=kv_quant)


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("n_blocks", [10, 14])
def test_fewer_blocks_give_the_tokens_of_a_full_pool(program, n_blocks,
                                                     kv_quant):
    """6 requests, 4 slots, 8-token blocks: a full pool holds 1 + 4 x 16
    blocks; 9 or 13 usable blocks admit one to three requests at a time.
    Each request's tokens are equal; every block comes back."""
    full = _batcher(program, kv_quant=kv_quant)
    want = full.run(_requests())
    small = _batcher(program, n_blocks, kv_quant=kv_quant)
    assert small.n_blocks < full.n_blocks
    assert small.run(_requests()) == want
    assert len(small._free_blocks) == n_blocks - 1
    assert [len(t) for t in want] != [len(want[0])] * len(want)


@pytest.mark.parametrize("contract", [CriticResult, EditorResult],
                         ids=lambda c: c.__name__)
def test_fewer_blocks_guided_give_the_tokens_of_a_full_pool(program, contract):
    def run(batcher):
        requests = [GenRequest(r.prompt_ids, 48) for r in _requests()]
        results = batcher.run_guided(requests, contract.json_schema(),
                                     TOKENIZER)
        return results, [r.tokens for r in requests]

    want = run(_batcher(program))
    got = run(_batcher(program, 17))
    assert got == want


def test_a_request_larger_than_the_pool_raises_at_once(program):
    batcher = _batcher(program, 5)          # 4 usable blocks = 32 tokens
    fits = GenRequest(np.arange(8, dtype=np.int32), 8)
    too_big = GenRequest(np.arange(20, dtype=np.int32), 20)
    with pytest.raises(RuntimeError, match="more KV blocks than the pool"):
        batcher.run([fits, too_big])
    with pytest.raises(RuntimeError, match="more KV blocks than the pool"):
        batcher.run_guided([too_big], CriticResult.json_schema(), TOKENIZER)
    assert fits.tokens == [] and batcher.stats["prefill_s"] == 0.0
    assert len(batcher._free_blocks) == 4


def test_requests_that_finish_in_prefill_do_not_stall_the_queue(program):
    """A pool that holds one request at a time, and requests of one token
    each: every admitted request retires in its prefill, and the queue
    still drains."""
    batcher = _batcher(program, 3)
    requests = [GenRequest(np.arange(n, dtype=np.int32), 1)
                for n in (3, 9, 12)]
    got = batcher.run(requests)
    assert got == _batcher(program).run(
        [GenRequest(r.prompt_ids, 1) for r in requests])
    assert all(len(t) <= 1 for t in got)


def _engines(pool_bytes=(None, None)):
    _, vl_cfg = configs(vocab_size=300, eos_token_id=EOS)
    q_cfg = Qwen3Config(**TINY_QWEN3)
    ocr = TorchOCRBackend(VLModel(init_vl(vl_cfg, torch.float32, "cpu"),
                                  vl_cfg), TOKENIZER, device="cpu",
                          pool_bytes=pool_bytes[0])
    llm = TorchReasoningBackend(Qwen3Model(init_qwen3(q_cfg, torch.float32,
                                                      "cpu"), q_cfg),
                                TOKENIZER, device="cpu",
                                pool_bytes=pool_bytes[1])
    return ocr, llm


def test_plan_pools_hands_each_engine_its_budget():
    ocr, llm = _engines()
    llm._ensure_batcher(100)
    card = 5 * 10**7
    plan = plan_pools(ocr, llm, card_bytes=card)
    assert llm._batcher is None                  # rebuilt within the budget
    assert ocr.pool_bytes == plan.component("vl_kv")
    assert llm.pool_bytes == plan.component("llm_kv")
    assert plan.component("vl_params[bf16]") == budget.tree_bytes(
        ocr.model.params)
    assert plan.hbm_per_chip == card and plan.n_chips == 1
    for engine in (ocr, llm):
        batcher = engine._ensure_batcher(16384)
        cfg = engine.model.config
        cfg = getattr(cfg, "text", cfg)
        per_block = PagedKVCache.block_bytes(
            cfg.num_hidden_layers, cfg_mod.SERVE_BLOCK_SIZE,
            cfg.num_key_value_heads, cfg.head_dim, torch.float32,
            engine.kv_quant)
        assert batcher.n_blocks == min(1 + 24 * 128,
                                       engine.pool_bytes // per_block)


def test_an_engine_alone_on_the_cpu_keeps_the_full_pool():
    ocr, llm = _engines()
    assert llm._ensure_batcher(1000).n_blocks == 1 + 24 * 8
    _, small = _engines(pool_bytes=(None, 10**6))
    batcher = small._ensure_batcher(1000)
    assert batcher.n_blocks == 10**6 // PagedKVCache.block_bytes(
        2, 128, 2, 16, torch.float32, True)
    _, empty = _engines(pool_bytes=(None, 10))
    with pytest.raises(RuntimeError, match="holds no block"):
        empty._ensure_batcher(1000)
