"""The reasoning backend end to end: ``TorchReasoningBackend`` against
``JaxReasoningBackend`` on the same tiny int8 Qwen3.

The weights are drawn by the JAX package's ``init_qwen3(quantize="int8")``
and carried over. The JAX backend on the CPU decodes over a full-precision
KV cache, so the port's runs with ``kv_quant=False`` here. The tokenizer
spells every id, so the texts carry the whole greedy token stream; they
must be equal. The vocabulary covers the chat template's special ids.
Schema-guided chat is held against JAX in ``test_torch_guided.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from handwritten_ocr_tpu.engine.jax_engines import JaxReasoningBackend
from handwritten_ocr_tpu.models.init import init_qwen3 as jax_init_qwen3
from handwritten_ocr_tpu.models.processor import (
    llm_chat_prompt as jax_llm_chat_prompt)
from handwritten_ocr_tpu.models.qwen3 import (Qwen3Config as JaxQwen3Config,
                                              Qwen3Model as JaxQwen3Model)
from handwritten_ocr_tpu_torch.engine.torch_engines import TorchReasoningBackend
from handwritten_ocr_tpu_torch.models.processor import (ByteTokenizer,
                                                        llm_chat_prompt)
from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model
from handwritten_ocr_tpu_torch.models.weights import from_jax_params

torch.set_num_threads(1)

TINY = dict(vocab_size=152000, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=32, eos_token_id=0,
            pad_token_id=0)


class SpellingTokenizer(ByteTokenizer):
    def decode(self, ids) -> str:
        return " ".join(str(int(i)) for i in ids)


class Turn:
    def __init__(self, system, user):
        self.system, self.user = system, user


TURNS = [Turn("You are an editor.", "Fix: teh cat"),
         Turn("sys", "a much longer user message that lands in another "
                     "prefill bucket than the first one does")]


@pytest.fixture(scope="module")
def models():
    cfg = JaxQwen3Config(**TINY)
    tree = jax_init_qwen3(jax.random.PRNGKey(21), cfg, dtype=jnp.float32,
                          quantize="int8")
    tree = jax.tree_util.tree_map(np.asarray, tree)
    return (JaxQwen3Model(tree, cfg),
            Qwen3Model(from_jax_params(tree), Qwen3Config(**TINY)))


def backend(model, **kw):
    return TorchReasoningBackend(model, SpellingTokenizer(), device="cpu",
                                 kv_quant=False, **kw)


def test_chat_template_matches_jax():
    for thinking in (False, True):
        assert llm_chat_prompt("s", "u", thinking) == \
            jax_llm_chat_prompt("s", "u", thinking)
    assert llm_chat_prompt("", "u") == jax_llm_chat_prompt("", "u")


def test_chat_batch_matches_jax(models):
    jax_model, port_model = models
    with jax.default_matmul_precision("highest"):
        want = JaxReasoningBackend(jax_model, SpellingTokenizer()).chat_batch(
            TURNS, temperature=0.1, max_tokens=6)
    port = backend(port_model)
    got = port.chat_batch(TURNS, temperature=0.1, max_tokens=6)
    assert got == want
    assert all(len(text.split()) == 6 for text in got)
    assert port.chat(TURNS[0].system, TURNS[0].user, temperature=0.1,
                     max_tokens=6) == got[0]
    assert not port._batcher.cache.quantized


def test_int8_kv_is_the_default(models):
    _, port_model = models
    port = TorchReasoningBackend(port_model, SpellingTokenizer(), device="cpu")
    text = port.chat("sys", "short", temperature=0.1, max_tokens=3)
    assert len(text.split()) == 3
    assert port._batcher.cache.quantized


def test_growing_the_context_releases_the_old_pools(models, monkeypatch):
    """When a longer call needs a larger context bound, the old batcher
    and its KV pools are gone before the new pools are allocated (both
    sets would not fit beside two resident models on the card); the
    answer equals that of a backend that starts at the larger bound."""
    import weakref
    from handwritten_ocr_tpu_torch.engine import serving
    _, port_model = models
    port = backend(port_model)
    port.chat("s", "u", temperature=0.1, max_tokens=4)
    assert port._batcher.max_context == 512
    old_pool = weakref.ref(port._batcher.cache.k)
    seen = []
    zeros = serving.PagedKVCache.zeros

    def watching_zeros(*args, **kwargs):
        seen.append(old_pool() is None)
        return zeros(*args, **kwargs)

    monkeypatch.setattr(serving.PagedKVCache, "zeros", watching_zeros)
    long_user = "x" * 600
    text = port.chat("s", long_user, temperature=0.1, max_tokens=4)
    assert port._batcher.max_context == 1024
    assert seen == [True]
    assert text == backend(port_model).chat("s", long_user, temperature=0.1,
                                            max_tokens=4)


def test_streaming_prints_the_text_once(models, capsys):
    _, port_model = models
    text = backend(port_model, stream=True).chat(
        "sys", "short", temperature=0.1, max_tokens=7)
    assert capsys.readouterr().out == text + "\n"
    backend(port_model, stream=True).chat_batch(TURNS, temperature=0.1,
                                                max_tokens=3)
    assert capsys.readouterr().out == ""      # no stream for a batch
