"""A tiny Qwen3 with int8 weights and int8 KV: the port against the JAX
package.

The weights are drawn by the JAX package's ``init_qwen3(quantize="int8")``
(fp32, QK-norm, no attention biases) and carried over with
``from_jax_params``. The JAX side runs its CPU path with its flash kernel
in the Pallas interpreter (``HOCR_TPU_FLASH=interpret``), so that a fresh
prefill attends over its full-precision k/v as on the accelerator and as
the port does; decode steps run its portable int8-KV path, the same
function as its paged kernel. fp32 throughout: the prefill logits agree
within 1e-4 (the same sums in another order) and the greedy tokens of the
continuous batchers are equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from handwritten_ocr_tpu.engine.serving import (
    ContinuousBatcher as JaxBatcher, GenRequest as JaxRequest,
    PagedProgram as JaxProgram)
from handwritten_ocr_tpu.models.init import init_qwen3 as jax_init_qwen3
from handwritten_ocr_tpu.models.paged import (PagedKVCache as JaxCache,
                                              paged_forward as jax_forward)
from handwritten_ocr_tpu.models.qwen25vl.language import (
    lm_logits as jax_lm_logits)
from handwritten_ocr_tpu.models.qwen3 import Qwen3Config as JaxQwen3Config
from handwritten_ocr_tpu_torch.engine.serving import (ContinuousBatcher,
                                                      GenRequest, PagedProgram)
from handwritten_ocr_tpu_torch.models.init import init_qwen3
from handwritten_ocr_tpu_torch.models.paged import PagedKVCache, paged_forward
from handwritten_ocr_tpu_torch.models.qwen25vl.language import lm_logits
from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model
from handwritten_ocr_tpu_torch.models.weights import from_jax_params

torch.set_num_threads(1)

EOS = 7
TINY = dict(vocab_size=300, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=32, eos_token_id=EOS,
            pad_token_id=0)
BATCHER = dict(n_slots=2, block_size=8, max_context=96, chunk=5,
               prefill_bucket=16)


@pytest.fixture(scope="module")
def tiny():
    cfg = JaxQwen3Config(**TINY)
    tree = jax_init_qwen3(jax.random.PRNGKey(3), cfg, dtype=jnp.float32,
                          quantize="int8")
    rng = np.random.default_rng(3)

    def perturb(path, leaf):   # non-trivial norms (init makes them ones)
        leaf = np.asarray(leaf)
        if "scale" in jax.tree_util.keystr(path):
            return (leaf + rng.normal(0, 0.1, leaf.shape)).astype(np.float32)
        return leaf

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    return cfg, tree, from_jax_params(tree)


@pytest.fixture
def jax_flash_interpret(monkeypatch):
    monkeypatch.setenv("HOCR_TPU_FLASH", "interpret")


def requests(cls):
    rng = np.random.default_rng(4)
    return [cls(rng.integers(10, 300, n).astype(np.int32), budget)
            for n, budget in ((5, 9), (13, 6), (19, 9))]


def test_config_and_tree(tiny):
    cfg, _, port = tiny
    assert Qwen3Config(**TINY) == Qwen3Config.from_hf(
        {**TINY, "eos_token_id": [EOS], "unknown": 1})
    big = Qwen3Config()
    assert (big.num_attention_heads * big.head_dim, big.hidden_size) == \
        (8192, 5120)
    assert big.mrope_section is None
    layer = port["layers"][0]
    assert layer["attn"]["q"]["w_q"].shape == (4 * 32, 128)
    assert layer["attn"]["q"]["w_scale"].dtype == torch.float32
    assert layer["attn"]["q_norm"]["scale"].shape == (32,)
    assert "b" not in layer["attn"]["q"]
    assert port["lm_head"]["w_q"].shape == (300, 128)
    assert len(port["layers"]) == 2


def test_init_qwen3_layout_matches_the_carried_tree(tiny):
    _, _, port = tiny
    drawn = init_qwen3(Qwen3Config(**TINY), dtype=torch.float32,
                       device="cpu", seed=1, quantize="int8")

    def shapes(tree, path=()):
        if isinstance(tree, dict):
            return {k: v for key, value in tree.items()
                    for k, v in shapes(value, path + (key,)).items()}
        if isinstance(tree, list):
            return {k: v for i, value in enumerate(tree)
                    for k, v in shapes(value, path + (i,)).items()}
        return {path: (tuple(tree.shape), tree.dtype)}

    assert shapes(drawn) == shapes(port)
    with pytest.raises(ValueError, match="quantize"):
        init_qwen3(Qwen3Config(**TINY), device="cpu", quantize="int4")


def test_prefill_logits_match_jax(tiny, jax_flash_interpret):
    cfg, tree, port = tiny
    port_cfg = Qwen3Config(**TINY)
    rng = np.random.default_rng(5)
    bucket, true_len = 16, np.array([11, 16], np.int32)
    ids = rng.integers(10, 300, (2, bucket))
    pos = np.broadcast_to(np.arange(bucket), (2, bucket))
    dims = (2, 9, 8, 2, 4, 2, 32)
    tables = np.array([[1, 2, 0, 0], [3, 4, 0, 0]], np.int32)
    with jax.default_matmul_precision("highest"):
        jcache = JaxCache.zeros(*dims, dtype=jnp.float32, kv_quant=True)
        jcache = jcache._replace(block_tables=jnp.asarray(tables))
        hidden, _ = jax_forward(
            tree, cfg, jnp.asarray(tree["embed"]["w"])[ids], jnp.asarray(pos),
            jcache, jnp.arange(2), jnp.zeros(2, jnp.int32),
            jnp.asarray(true_len), fresh=True)
        want = np.asarray(jax_lm_logits(tree, cfg, hidden))
    tcache = PagedKVCache.zeros(*dims, dtype=torch.float32, kv_quant=True)
    tcache.block_tables.copy_(torch.from_numpy(tables))
    hidden = paged_forward(port, port_cfg, port["embed"]["w"][ids],
                           torch.from_numpy(pos.copy()), tcache,
                           torch.arange(2), torch.zeros(2, dtype=torch.int32),
                           torch.from_numpy(true_len), fresh=True)
    got = lm_logits(port, port_cfg, hidden).numpy()
    for row, n in enumerate(true_len):
        np.testing.assert_allclose(got[row, :n], want[row, :n], rtol=1e-4,
                                   atol=1e-4)
    assert tcache.quantized and tcache.k.dtype == torch.int8
    assert bool((tcache.k_scale[:, 1:5] > 0).all())


def test_int8_batcher_matches_jax(tiny, jax_flash_interpret):
    cfg, tree, port = tiny
    with jax.default_matmul_precision("highest"):
        want = JaxBatcher(JaxProgram(tree, cfg), dtype=jnp.float32,
                          kv_quant=True, **BATCHER).run(requests(JaxRequest))
    batcher = ContinuousBatcher(PagedProgram(port, Qwen3Config(**TINY)),
                                dtype=torch.float32, device="cpu",
                                kv_quant=True, **BATCHER)
    got = batcher.run(requests(GenRequest))
    assert got == want
    assert [len(t) for t in got] == [9, 6, 9]
    assert batcher.cache.quantized
    assert len(batcher._free_blocks) == batcher.n_blocks - 1


def test_holder_keeps_params_and_config(tiny):
    _, _, port = tiny
    model = Qwen3Model(port, Qwen3Config(**TINY))
    assert model.params is port and model.config.head_dim == 32
