"""The dense (contiguous-cache) decode path: the port's ``text_forward``
over a ``KVCache``, ``Qwen3Model.generate`` / ``generate_json`` /
``forward_logits``, ``VLModel.generate`` / ``forward_logits``,
``utils/json_guard.py`` and both engines with ``serving="dense"``,
against the JAX package's, on the same tiny fp32 weights.

The weights are drawn by the JAX ``init_*`` and carried over with
``from_jax_params``; inputs come from a numpy seed. Greedy tokens must be
equal. Hidden states and logits are compared in fp32 within 1e-4
absolute (values of order 1; the same sums in another order, and the
JAX package's CPU prefill takes the plain masked attention where the
port's takes flash attention's plain version). Inside the port, paged
serving must give the dense path's tokens (the JAX package's
``test_*_paged_matches_dense``).
"""

import json
import random
import string

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handwritten_ocr_tpu.engine.jax_engines import (JaxOCRBackend,
                                                    JaxReasoningBackend,
                                                    TPUPreprocessor)
from handwritten_ocr_tpu.models.init import init_qwen3 as jax_init_qwen3
from handwritten_ocr_tpu.models.qwen25vl import language as jax_language
from handwritten_ocr_tpu.models.qwen25vl.model import VLModel as JaxVLModel
from handwritten_ocr_tpu.models.qwen3 import (Qwen3Config as JaxQwen3Config,
                                              Qwen3Model as JaxQwen3Model)
from handwritten_ocr_tpu.utils import json_guard as jax_json_guard
from handwritten_ocr_tpu_torch.agents.schemas import CriticResult
from handwritten_ocr_tpu_torch.config import PREPROCESSING_STRATEGIES
from handwritten_ocr_tpu_torch.engine.torch_engines import (
    TorchOCRBackend, TorchPreprocessor, TorchReasoningBackend, plan_pools)
from handwritten_ocr_tpu_torch.models.processor import ByteTokenizer, pack_image
from handwritten_ocr_tpu_torch.models.qwen25vl import language
from handwritten_ocr_tpu_torch.models.qwen25vl.model import VLModel
from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model
from handwritten_ocr_tpu_torch.models.weights import from_jax_params
from handwritten_ocr_tpu_torch.utils import json_guard
from torch_port_tiny import SMALL_TOKENIZER, configs, jax_tree, port_tree

torch.set_num_threads(1)

ATOL = 1e-4
EOS = SMALL_TOKENIZER.SPECIALS["<|im_end|>"]
QWEN3 = dict(vocab_size=300, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
             head_dim=16, eos_token_id=EOS, pad_token_id=0)
PIXELS = dict(min_pixels=28 * 28, max_pixels=112 * 112)


@pytest.fixture(scope="module")
def qwen3():
    """(JAX model, port model) on the same fp32 weights, with non-trivial
    norms (the init's ones would hide a dropped scale)."""
    cfg = JaxQwen3Config(**QWEN3)
    tree = jax_init_qwen3(jax.random.PRNGKey(8), cfg, dtype=jnp.float32)
    rng = np.random.default_rng(8)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        if "scale" in jax.tree_util.keystr(path):
            return (leaf + rng.normal(0, 0.1, leaf.shape)).astype(np.float32)
        return leaf

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    return (JaxQwen3Model(tree, cfg),
            Qwen3Model(from_jax_params(tree), Qwen3Config(**QWEN3)))


@pytest.fixture(scope="module")
def vl():
    """(JAX model, port model) of the tiny Qwen2.5-VL."""
    jax_cfg, port_cfg = configs(vocab_size=152064)
    tree = jax_tree(jax_cfg, seed=9)
    return (JaxVLModel(tree, jax_cfg),
            VLModel(port_tree(jax.tree_util.tree_map(np.asarray, tree)),
                    port_cfg))


def _page(seed, height=56, width=84):
    rng = np.random.default_rng(seed)
    page = np.clip(rng.normal(220, 25, (height, width, 3)), 0, 255)
    return page.astype(np.uint8)


def _vl_prompt(cfg, grid, seed=0):
    """Text, an image-token run for ``grid``, text: one prompt row."""
    rng = np.random.default_rng(seed)
    n_image = grid[0] * grid[1] * grid[2] // 4
    return np.concatenate([rng.integers(10, 200, 5),
                           [cfg.vision_start_token_id],
                           np.full(n_image, cfg.image_token_id),
                           rng.integers(10, 200, 7)]).astype(np.int32)


# ── json_guard ────────────────────────────────────────────────────────

VALID_DOCS = [
    '{}', '[]', '{"a": 1}', '[1, 2, 3]', '"hello"', 'true', 'false', 'null',
    '42', '-3.14', '1e10', '0', '{"a": {"b": [1, "x", null]}, "c": false}',
    '{"s": "with \\"escape\\" and } brace"}', '[[], {}, [{}]]',
    '{"overall_confidence": 88, "segments": [], "verdict": "accept"}',
    '  {"padded": true}  ', '"\\u00e9"', '[true, false]', '{"k": -0.5e-2}',
]
INVALID = [
    '}', ']', '{,', '{"a" 1}', '{"a":}1', '[1 2', '{"a": 1,,', 'truex',
    'nul{', '01', '{"a": 01}', '-{', '[,', '{"a": "b" "c"', '{"a"}',
    '1 2', '"done" extra', '{} {}', '[1] null',
]
INCOMPLETE = ['{', '{"a"', '{"a":', '[1,', '"unterminated', '-', '1e',
              '{"a": [tru', '"line\nbreak"']


def _fuzz(seed, n=500):
    """Random strings over JSON's characters (the JAX package's fuzz)."""
    rng = random.Random(seed)
    alphabet = '{}[]",:0123456789.eE+-truefalsnul \n' + string.ascii_lowercase
    return ["".join(rng.choice(alphabet) for _ in range(rng.randrange(1, 12)))
            for _ in range(n)]


@pytest.mark.parametrize("docs", [[d] for d in VALID_DOCS + INVALID + INCOMPLETE]
                         + [_fuzz(seed) for seed in range(6)],
                         ids=lambda docs: repr(docs[0])[:24])
def test_json_guard_matches_jax(docs):
    """Every prefix of every document: the same ``is_viable_prefix`` and
    ``is_complete``, and the same scanner state fed one character at a
    time; complete documents parse."""
    for doc in docs:
        scanner, jax_scanner = json_guard.JsonScanner(), jax_json_guard.JsonScanner()
        for i in range(len(doc) + 1):
            prefix = doc[:i]
            assert (json_guard.is_viable_prefix(prefix)
                    == jax_json_guard.is_viable_prefix(prefix)), prefix
            assert (json_guard.is_complete(prefix)
                    == jax_json_guard.is_complete(prefix)), prefix
            if i:
                assert scanner.feed(doc[i - 1]) == jax_scanner.feed(doc[i - 1])
                assert scanner.viable() == jax_scanner.viable()
                assert scanner.complete() == jax_scanner.complete()
        if json_guard.is_complete(doc):
            json.loads(doc)


# ── text_forward ──────────────────────────────────────────────────────

def _text_tree(model):
    return model.params["text"] if "text" in model.params else model.params


@pytest.mark.parametrize("kind", ["qwen3", "vl"])
@pytest.mark.parametrize("mode", ["no_cache", "cache", "key_padding"])
def test_text_forward_matches_jax(qwen3, vl, kind, mode):
    """The decoder stack without a cache, with a cache (a 9-token prefill,
    then two single-token steps), and with key padding (row 0's first four
    keys are padding; a prefill into the cache, then one step): hidden
    states within ATOL; the cache's rows below its cursor within ATOL, and
    its cursor."""
    jax_model, model = {"qwen3": qwen3, "vl": vl}[kind]
    cfg, jax_cfg = ((model.config, jax_model.config) if kind == "qwen3"
                    else (model.config.text, jax_model.config.text))
    tree, jax_text = _text_tree(model), _text_tree(jax_model)
    rng = np.random.default_rng(2)
    batch, t, max_len = 2, 9, 16
    ids = rng.integers(0, 300, (batch, t))

    def positions(offset, n):
        pos = np.broadcast_to(np.arange(offset, offset + n), (batch, n))
        return np.array(pos if kind == "qwen3"
                        else np.broadcast_to(pos, (3, batch, n)))

    padding = None
    if mode == "key_padding":
        padding = np.ones((batch, max_len), bool)
        padding[0, :4] = False
    steps = [(ids, positions(0, t))]
    if mode != "no_cache":
        steps += [(rng.integers(0, 300, (batch, 1)), positions(t, 1))]
        if mode == "cache":
            steps += [(rng.integers(0, 300, (batch, 1)), positions(t + 1, 1))]
    cache = None
    jax_cache = None
    if mode != "no_cache":
        cache = language.KVCache.zeros(cfg.num_hidden_layers, batch, max_len,
                                       cfg.num_key_value_heads, cfg.head_dim,
                                       dtype=torch.float32)
        jax_cache = jax_language.KVCache.zeros(
            jax_cfg.num_hidden_layers, batch, max_len,
            jax_cfg.num_key_value_heads, jax_cfg.head_dim, dtype=jnp.float32)
    for step_ids, pos in steps:
        embeds = np.asarray(jax_text["embed"]["w"])[step_ids]
        pad = None if padding is None else padding[:, :max_len if cache else t]
        with jax.default_matmul_precision("highest"):
            want, jax_cache = jax_language.text_forward(
                jax_text, jax_cfg, jnp.asarray(embeds), jnp.asarray(pos),
                jax_cache, None if pad is None else jnp.asarray(pad))
        got, cache = language.text_forward(
            tree, cfg, torch.as_tensor(embeds), torch.as_tensor(pos), cache,
            None if pad is None else torch.as_tensor(pad))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
    if cache is not None:
        assert cache.cursor == int(jax_cache.cursor)
        for pool, jax_pool in ((cache.k, jax_cache.k), (cache.v, jax_cache.v)):
            np.testing.assert_allclose(pool[:, :, :cache.cursor].numpy(),
                                       np.asarray(jax_pool)[:, :, :cache.cursor],
                                       rtol=0, atol=ATOL)


def test_chunked_attention_is_the_same_function(monkeypatch):
    """Query chunks under a small score budget give the unchunked
    result: each query row's softmax is its own."""
    rng = np.random.default_rng(3)
    q = torch.as_tensor(rng.normal(size=(2, 13, 4, 16)), dtype=torch.float32)
    k = torch.as_tensor(rng.normal(size=(2, 20, 2, 16)), dtype=torch.float32)
    v = torch.as_tensor(rng.normal(size=(2, 20, 2, 16)), dtype=torch.float32)
    mask = torch.as_tensor(rng.random((2, 1, 13, 20)) > 0.3)
    whole = language._chunked_attention(q, k, v, mask, 0.25)
    monkeypatch.setattr(language, "SCORE_BYTES", 2 * 4 * 20 * 4 * 3)
    chunked = language._chunked_attention(q, k, v, mask, 0.25)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=1e-6)


# ── Qwen3Model ────────────────────────────────────────────────────────

def _left_padded(rng, lengths, pad_id=0):
    longest = max(lengths)
    ids = np.full((len(lengths), longest), pad_id, np.int32)
    mask = np.zeros((len(lengths), longest), bool)
    for row, n in enumerate(lengths):
        ids[row, longest - n:] = rng.integers(0, 256, n)
        mask[row, longest - n:] = True
    return ids, mask


@pytest.mark.parametrize("padded", [False, True], ids=["plain", "left_padded"])
def test_qwen3_generate_matches_jax(qwen3, padded):
    """Greedy tokens and lengths equal to JAX's: one batch of equal-length
    rows (flash prefill), one left-padded batch (masked prefill,
    positions from 0 on each row's first real token)."""
    jax_model, model = qwen3
    rng = np.random.default_rng(4)
    ids, mask = _left_padded(rng, [12, 5, 9] if padded else [10, 10])
    mask = mask if padded else None
    with jax.default_matmul_precision("highest"):
        want = jax_model.generate(ids, 14, pad_mask=mask)
    got = model.generate(ids, 14, pad_mask=mask)
    assert got.tokens.tolist() == np.asarray(want.tokens).tolist()
    assert got.lengths.tolist() == np.asarray(want.lengths).tolist()
    assert got.tokens.dtype == torch.int32


def test_qwen3_generate_json_matches_jax(qwen3):
    """The JSON-prefix guard commits the same candidates: equal texts,
    viable JSON prefixes."""
    jax_model, model = qwen3
    rng = np.random.default_rng(5)
    for n, budget in ((7, 24), (15, 40)):
        ids = rng.integers(0, 256, (1, n)).astype(np.int32)
        with jax.default_matmul_precision("highest"):
            want = jax_model.generate_json(ids, budget, SMALL_TOKENIZER)
        got = model.generate_json(ids, budget, SMALL_TOKENIZER)
        assert got == want
        assert got and json_guard.is_viable_prefix(got.rstrip("�"))


def test_qwen3_forward_logits_matches_jax(qwen3):
    jax_model, model = qwen3
    ids = np.random.default_rng(6).integers(0, 300, (2, 11))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_model.forward_logits(ids))
    got = model.forward_logits(ids)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


# ── VLModel ───────────────────────────────────────────────────────────

@pytest.mark.parametrize("image", [True, False], ids=["page", "text_only"])
def test_vl_generate_and_logits_match_jax(vl, image):
    """Vision encode + splice + M-RoPE prefill + decode at cursor +
    rope_delta: greedy tokens and lengths equal to JAX's, and the
    full-sequence logits within ATOL; two rows of one page layout."""
    jax_model, model = vl
    patches = grid = None
    if image:
        packed = pack_image(_page(0), **PIXELS)
        patches, grid = np.stack([packed.patches] * 2), packed.grid
        ids = _vl_prompt(model.config, grid)
    else:
        ids = np.random.default_rng(7).integers(10, 200, 12).astype(np.int32)
    ids = np.tile(ids, (2, 1))
    with jax.default_matmul_precision("highest"):
        jax_patches = None if patches is None else jnp.asarray(patches)
        want = jax_model.generate(ids, jax_patches, grid, 9)
        want_logits = np.asarray(jax_model.forward_logits(ids, jax_patches,
                                                          grid))
    port_patches = None if patches is None else torch.as_tensor(patches)
    got = model.generate(ids, port_patches, grid, 9)
    assert got.tokens.tolist() == np.asarray(want.tokens).tolist()
    assert got.lengths.tolist() == np.asarray(want.lengths).tolist()
    np.testing.assert_allclose(
        model.forward_logits(ids, port_patches, grid).numpy(), want_logits,
        rtol=0, atol=ATOL)


# ── the engines ───────────────────────────────────────────────────────

class SpellingTokenizer(ByteTokenizer):
    """The chat template's special ids at Qwen's own values (the image
    token among them); decode spells every id."""

    def decode(self, ids) -> str:
        return " ".join(str(int(i)) for i in ids)


@pytest.fixture(scope="module")
def pages(tmp_path_factory):
    from PIL import Image
    root = tmp_path_factory.mktemp("dense_pages")
    paths = []
    for name, seed, shape in (("a", 0, (60, 80)), ("b", 1, (90, 70))):
        path = root / f"{name}.png"
        Image.fromarray(_page(seed, *shape)).save(path)
        paths.append(str(path))
    return paths


def test_ocr_backend_dense_matches_jax_and_paged(vl, pages):
    """Two pages of different grids x two strategies: the dense read
    equals ``JaxOCRBackend(serving="dense")``'s and the port's own paged
    read (fp KV); the dense engine builds no batcher."""
    jax_model, model = vl
    tokenizer = SpellingTokenizer()
    strategies = PREPROCESSING_STRATEGIES[:2]
    with jax.default_matmul_precision("highest"):
        prep = TPUPreprocessor(**PIXELS)
        images = [prep.apply(p, s) for p in pages for s in strategies]
        want = JaxOCRBackend(jax_model, tokenizer, serving="dense",
                             **PIXELS).read_batch(images, "Read.", 6)
    prep = TorchPreprocessor(device="cpu", **PIXELS)
    images = [prep.apply(p, s) for p in pages for s in strategies]
    dense = TorchOCRBackend(model, tokenizer, device="cpu", serving="dense",
                            **PIXELS)
    got = dense.read_batch(images, "Read.", 6)
    assert got == want
    assert dense._batcher is None
    paged = TorchOCRBackend(model, tokenizer, device="cpu", kv_quant=False,
                            **PIXELS)
    assert paged.serving == "paged"
    assert paged.read_batch(images, "Read.", 6) == got


class Turn:
    def __init__(self, system, user):
        self.system, self.user = system, user


TURNS = [Turn("You are an editor.", "Fix: teh cat"),
         Turn("sys", "a much longer user message that lands in another "
                     "prefill bucket than the first one does"),
         Turn("x", "y")]


def test_reasoning_backend_dense_matches_jax_and_paged(qwen3):
    """``chat_batch`` (left-padded), ``chat`` and ``chat(json_schema)``
    (``generate_json``) give the texts of
    ``JaxReasoningBackend(serving="dense")``; free decode also equals the
    port's own paged engine (fp KV)."""
    jax_model, model = qwen3
    tokenizer = SMALL_TOKENIZER
    schema = CriticResult.json_schema()
    kw = dict(temperature=0.1, max_tokens=24)
    jax_side = JaxReasoningBackend(jax_model, tokenizer, serving="dense")
    with jax.default_matmul_precision("highest"):
        want = (jax_side.chat_batch(TURNS, **kw),
                jax_side.chat(TURNS[0].system, TURNS[0].user, **kw),
                jax_side.chat(TURNS[1].system, TURNS[1].user,
                              json_schema=schema, **kw))
    dense = TorchReasoningBackend(model, tokenizer, device="cpu",
                                  serving="dense")
    got = (dense.chat_batch(TURNS, **kw),
           dense.chat(TURNS[0].system, TURNS[0].user, **kw),
           dense.chat(TURNS[1].system, TURNS[1].user, json_schema=schema,
                      **kw))
    assert got == want
    assert dense._batcher is None
    paged = TorchReasoningBackend(model, tokenizer, device="cpu",
                                  kv_quant=False)
    assert paged.chat_batch(TURNS, **kw) == got[0]
    assert paged.chat(TURNS[0].system, TURNS[0].user, **kw) == got[1]


def test_serving_mode_comes_from_the_environment(monkeypatch):
    monkeypatch.setenv("HOCR_VL_SERVING", "dense")
    monkeypatch.setenv("HOCR_LLM_SERVING", "dense")
    assert TorchOCRBackend(None, SMALL_TOKENIZER, device="cpu").serving == "dense"
    assert TorchReasoningBackend(None, SMALL_TOKENIZER,
                                 device="cpu").serving == "dense"
    assert TorchOCRBackend(None, SMALL_TOKENIZER, device="cpu",
                           serving="paged").serving == "paged"
    monkeypatch.delenv("HOCR_VL_SERVING")
    monkeypatch.delenv("HOCR_LLM_SERVING")
    assert TorchOCRBackend(None, SMALL_TOKENIZER, device="cpu").serving == "paged"
    assert TorchReasoningBackend(None, SMALL_TOKENIZER,
                                 device="cpu").serving == "paged"


@pytest.mark.parametrize("dense", ["ocr", "llm", "both", None])
def test_plan_pools_gives_a_dense_engines_share_away(vl, qwen3, dense):
    """Only paged engines get a pool budget; a dense engine's share goes
    to the other engine, and both engines' batchers are dropped."""
    ocr = TorchOCRBackend(vl[1], SMALL_TOKENIZER, device="cpu",
                          serving="dense" if dense in ("ocr", "both") else None)
    llm = TorchReasoningBackend(qwen3[1], SMALL_TOKENIZER, device="cpu",
                                serving="dense" if dense in ("llm", "both")
                                else None)
    ocr._batcher = llm._batcher = object()
    plan = plan_pools(ocr, llm, card_bytes=80 * 2 ** 30)
    vl_kv, llm_kv = plan.component("vl_kv"), plan.component("llm_kv")
    assert ocr._batcher is None and llm._batcher is None
    expect = {None: (vl_kv, llm_kv), "ocr": (None, vl_kv + llm_kv),
              "llm": (vl_kv + llm_kv, None), "both": (None, None)}[dense]
    assert (ocr.pool_bytes, llm.pool_bytes) == expect
