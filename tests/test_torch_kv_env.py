"""``HOCR_KV_INT8`` in the port's engines, against the JAX engines.

The JAX engines read ``HOCR_KV_INT8`` at construction
(``engine/jax_engines.py:_kv_quant``): ``"0"``, ``"off"`` or ``"false"``
turn the int8 KV cache off; otherwise they take int8 KV on the TPU only.
The port keeps one default on every device (``config.SERVE_KV_INT8``) and
the same allowlist; an explicit ``kv_quant`` wins. Under
``HOCR_KV_INT8=0`` tiny port engines on the CPU give the same greedy
tokens as the JAX engines on the CPU (which decode over full-precision KV
there), on the same weights; and a pool of bf16 blocks holds, under the
same byte budget, the int8 pool's blocks scaled by the two block sizes.
"""

import numpy as np
import pytest
import torch

import jax

from handwritten_ocr_tpu.engine import jax_engines
from handwritten_ocr_tpu.models.qwen25vl.model import VLModel as JaxVLModel
from handwritten_ocr_tpu_torch import config as cfg_mod
from handwritten_ocr_tpu_torch.engine.torch_engines import (
    TorchOCRBackend, TorchPreprocessor, TorchReasoningBackend)
from handwritten_ocr_tpu_torch.models.init import init_qwen3
from handwritten_ocr_tpu_torch.models.paged import PagedKVCache
from handwritten_ocr_tpu_torch.models.processor import ByteTokenizer
from handwritten_ocr_tpu_torch.models.qwen25vl.model import VLModel
from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model
from torch_port_tiny import configs, jax_tree, port_tree
from test_torch_engine import PIXELS, SpellingTokenizer, pages  # noqa: F401
from test_torch_reasoning import TURNS, models  # noqa: F401

torch.set_num_threads(1)


def engines(kv_quant=None):
    _, vl_cfg = configs(vocab_size=300)
    q_cfg = Qwen3Config(vocab_size=300, hidden_size=64, intermediate_size=128,
                        num_hidden_layers=2, num_attention_heads=4,
                        num_key_value_heads=2, head_dim=16)
    kw = {} if kv_quant is None else {"kv_quant": kv_quant}
    return (TorchOCRBackend(VLModel({}, vl_cfg), ByteTokenizer(), device="cpu",
                            **kw),
            TorchReasoningBackend(Qwen3Model({}, q_cfg), ByteTokenizer(),
                                  device="cpu", **kw))


@pytest.mark.parametrize("value", ["0", "off", "false", "", "1", None])
def test_env_resolves_as_the_jax_allowlist(value, monkeypatch):
    """The port's engines take fp KV exactly where JAX's ``_kv_quant``
    does once its device rule holds (a TPU backend), and int8 KV
    (``config.SERVE_KV_INT8``) everywhere else, on every device."""
    if value is None:
        monkeypatch.delenv("HOCR_KV_INT8", raising=False)
    else:
        monkeypatch.setenv("HOCR_KV_INT8", value)
    monkeypatch.setattr(jax_engines.jax, "default_backend", lambda: "tpu")
    want = jax_engines._kv_quant()
    assert want == (value not in ("0", "off", "false"))
    for engine in engines():
        assert engine.kv_quant is want
    assert cfg_mod.SERVE_KV_INT8 is True


@pytest.mark.parametrize("value", ["0", None])
@pytest.mark.parametrize("explicit", [True, False])
def test_an_explicit_kv_quant_wins(value, explicit, monkeypatch):
    if value is None:
        monkeypatch.delenv("HOCR_KV_INT8", raising=False)
    else:
        monkeypatch.setenv("HOCR_KV_INT8", value)
    for engine in engines(kv_quant=explicit):
        assert engine.kv_quant is explicit


def test_the_env_is_read_at_construction(monkeypatch):
    monkeypatch.setenv("HOCR_KV_INT8", "0")
    ocr, llm = engines()
    monkeypatch.delenv("HOCR_KV_INT8")
    assert ocr.kv_quant is False and llm.kv_quant is False


def test_fp_kv_read_from_the_env_matches_jax(pages, monkeypatch):  # noqa: F811
    """Two pages x two strategies through the tiny VL, JAX against the
    port engine built under ``HOCR_KV_INT8=0`` with no ``kv_quant``."""
    jax_cfg, port_cfg = configs()
    tree = jax_tree(jax_cfg, seed=12)
    tokenizer = SpellingTokenizer()
    strategies = cfg_mod.PREPROCESSING_STRATEGIES[:2]
    with jax.default_matmul_precision("highest"):
        jax_prep = jax_engines.TPUPreprocessor(**PIXELS)
        jax_images = [jax_prep.apply(p, s) for p in pages for s in strategies]
        want = jax_engines.JaxOCRBackend(
            JaxVLModel(tree, jax_cfg), tokenizer,
            **PIXELS).read_batch(jax_images, "Read.", 6)
    monkeypatch.setenv("HOCR_KV_INT8", "0")
    backend = TorchOCRBackend(
        VLModel(port_tree(jax.tree_util.tree_map(np.asarray, tree)), port_cfg),
        tokenizer, device="cpu", **PIXELS)
    prep = TorchPreprocessor(device="cpu", **PIXELS)
    images = [prep.apply(p, s) for p in pages for s in strategies]
    assert backend.read_batch(images, "Read.", 6) == want
    assert not backend._batcher.cache.quantized


def test_fp_kv_chat_from_the_env_matches_jax(models, monkeypatch):  # noqa: F811
    jax_model, port_model = models
    with jax.default_matmul_precision("highest"):
        want = jax_engines.JaxReasoningBackend(
            jax_model, SpellingTokenizer()).chat_batch(TURNS, temperature=0.1,
                                                       max_tokens=6)
    monkeypatch.setenv("HOCR_KV_INT8", "off")
    port = TorchReasoningBackend(port_model, SpellingTokenizer(), device="cpu")
    assert port.chat_batch(TURNS, temperature=0.1, max_tokens=6) == want
    assert not port._batcher.cache.quantized


@pytest.mark.parametrize("blocks", [4, 40, 101])
def test_fp_pool_holds_the_budget_at_bf16_block_bytes(blocks, monkeypatch):
    """A budget of exactly ``blocks`` int8 blocks: the bf16 pool built
    under ``HOCR_KV_INT8=0`` has floor(blocks x int8 bytes / bf16 bytes)
    blocks, about half; both below the full pool, so requests queue."""
    cfg = Qwen3Config(vocab_size=300, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, head_dim=16)
    params = init_qwen3(cfg, torch.bfloat16, "cpu")
    dims = (cfg.num_hidden_layers, cfg_mod.SERVE_BLOCK_SIZE,
            cfg.num_key_value_heads, cfg.head_dim, torch.bfloat16)
    int8_bytes = PagedKVCache.block_bytes(*dims, True)
    bf16_bytes = PagedKVCache.block_bytes(*dims, False)
    budget = blocks * int8_bytes
    n_blocks = {}
    for value in (None, "0"):
        if value is None:
            monkeypatch.delenv("HOCR_KV_INT8", raising=False)
        else:
            monkeypatch.setenv("HOCR_KV_INT8", value)
        engine = TorchReasoningBackend(Qwen3Model(params, cfg),
                                       ByteTokenizer(), device="cpu",
                                       pool_bytes=budget)
        batcher = engine._ensure_batcher(4096)
        assert batcher.cache.quantized is (value is None)
        n_blocks[value] = batcher.n_blocks
    assert n_blocks[None] == blocks
    assert n_blocks["0"] == blocks * int8_bytes // bf16_bytes
    assert n_blocks["0"] < 1 + cfg_mod.SERVE_SLOTS * 4096 // cfg_mod.SERVE_BLOCK_SIZE
