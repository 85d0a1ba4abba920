"""The JAX package's run-time options, read by the port as JAX reads them.

``HOCR_TPU_ROPE_FP32`` (read at each call of ``apply_rope``): bf16 q/k
rotate in fp32 when it is set and non-empty, else in bf16. The window
kernel and its plain version rope their own way whatever it says, as
JAX's window kernel does (``ops/window_attention.py``), so the bf16 read
below runs JAX's window kernel in the Pallas interpreter
(``HOCR_TPU_WINATTN=interpret``, as JAX's own window tests run it on the
CPU) and its flash kernel likewise (``HOCR_TPU_FLASH=interpret``, as
``tests/test_torch_engine.py``'s int8-KV read does).

``HOCR_VISION_CHUNK`` (read once, when ``config`` is imported): the pages
per vision-tower call.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_tiny import configs, jax_tree
from test_torch_engine import PIXELS, SpellingTokenizer, render_page
from handwritten_ocr_tpu.engine.jax_engines import (JaxOCRBackend,
                                                    TPUPreprocessor)
from handwritten_ocr_tpu.models import layers as jax_layers
from handwritten_ocr_tpu.models.qwen25vl.model import VLModel as JaxVLModel
from handwritten_ocr_tpu_torch import config as cfg_mod
from handwritten_ocr_tpu_torch.config import PREPROCESSING_STRATEGIES
from handwritten_ocr_tpu_torch.engine.torch_engines import (TorchOCRBackend,
                                                            TorchPreprocessor)
from handwritten_ocr_tpu_torch.models import layers as port_layers
from handwritten_ocr_tpu_torch.models.processor import (ByteTokenizer,
                                                        pack_image,
                                                        vlm_chat_prompt)
from handwritten_ocr_tpu_torch.models.qwen25vl import model as port_model
from handwritten_ocr_tpu_torch.models.qwen25vl.model import VLModel
from handwritten_ocr_tpu_torch.models.weights import from_jax_params

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
# tests/test_torch_layers.py's bf16 bound: a few bf16 ulps of unit-scale
# values, for products that round their sums at other points on each side
BF16_TOL = 3e-2


def _rope_inputs():
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.normal(0, 1, (2, 64, 4, 80)), jnp.bfloat16)
    k = jnp.asarray(rng.normal(0, 1, (2, 64, 2, 80)), jnp.bfloat16)
    angles = rng.normal(0, 3, (1, 64, 1, 80))
    cos = jnp.asarray(np.cos(angles), jnp.float32)
    sin = jnp.asarray(np.sin(angles), jnp.float32)
    jax_in = (q, k, cos, sin)
    port_in = [torch.from_numpy(np.array(x.astype(jnp.float32)))
               for x in jax_in]
    port_in[0], port_in[1] = port_in[0].bfloat16(), port_in[1].bfloat16()
    return jax_in, port_in


def _bf16_ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """How many bf16 steps apart the bf16 values ``a`` and ``b`` (held in
    float32 arrays) are."""
    def ordered(x):
        bits = (x.astype(np.float32).view(np.uint32) >> 16).astype(np.int64)
        return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("value", [None, "", "1"])
def test_apply_rope_follows_the_variable_bit_equal_to_jax(value, monkeypatch):
    """bf16 q/k with the variable unset, set but empty (both the bf16
    path) and set (the fp32 path): bit-equal to JAX's eager
    ``apply_rope``; against JAX's jitted one, bit-equal on the bf16 path
    and within 1 bf16 ulp on the fp32 path (XLA fuses the fp32 sum of
    products, which moves a rounding: 1 element of 40960 on these inputs).
    The two paths differ, so the test sees which one ran."""
    if value is None:
        monkeypatch.delenv("HOCR_TPU_ROPE_FP32", raising=False)
    else:
        monkeypatch.setenv("HOCR_TPU_ROPE_FP32", value)
    jax_in, port_in = _rope_inputs()
    got = port_layers.apply_rope(*port_in)
    jax.clear_caches()                        # JAX reads it while tracing
    eager = jax_layers.apply_rope(*jax_in)
    jitted = jax.jit(jax_layers.apply_rope)(*jax_in)
    for g, e, j in zip(got, eager, jitted):
        assert g.dtype == torch.bfloat16
        g = g.float().numpy()
        np.testing.assert_array_equal(g, np.asarray(e.astype(jnp.float32)))
        ulps = _bf16_ulps(g, np.asarray(j.astype(jnp.float32)))
        assert ulps.max() <= (1 if value else 0)
    monkeypatch.setenv("HOCR_TPU_ROPE_FP32", "" if value == "1" else "1")
    other = port_layers.apply_rope(*port_in)
    assert not torch.equal(other[0], got[0])
    jax.clear_caches()


def _prompt(cfg, packed):
    ids = np.asarray(ByteTokenizer().encode(vlm_chat_prompt("Read.", 1)))
    at = int(np.flatnonzero(ids == cfg.image_token_id)[0])
    return np.concatenate([ids[:at], np.full(packed.num_llm_tokens,
                                             cfg.image_token_id),
                           ids[at + 1:]])[None]


def test_bf16_read_with_rope_fp32_equals_jax(tmp_path, monkeypatch):
    """A tiny bf16 VL (JAX's weights rounded to bf16 on both sides):

    - with ``HOCR_TPU_ROPE_FP32=1``, the read of two pages x two
      strategies, 8 new tokens, gives JAX's greedy tokens (the VL read
      parity tests' tolerance: equal tokens);
    - with the variable set and unset, the logits of one page's prompt
      (``forward_logits``: vision tower, global layers' rope, the dense
      text rope) are within BF16_TOL of JAX's, and each side's logits
      change when the variable does: the read path sees it.

    Without the variable the 8-token read leaves JAX's stream at its last
    token on one row (a bf16 near-tie: the two frameworks round the
    model's other products at other points); that read is not compared."""
    monkeypatch.setenv("HOCR_TPU_WINATTN", "interpret")
    monkeypatch.setenv("HOCR_TPU_FLASH", "interpret")
    jax_cfg, port_cfg = configs()
    tree = jax.tree_util.tree_map(np.asarray, jax_tree(jax_cfg, seed=12))
    jax_params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16),
                                        tree)
    port_params = from_jax_params(tree, device="cpu", dtype=torch.bfloat16)
    pages = [render_page(tmp_path / "a.png", 60, 80, 0),
             render_page(tmp_path / "b.png", 90, 70, 1)]
    strategies = PREPROCESSING_STRATEGIES[:2]
    rng = np.random.default_rng(3)
    packed = pack_image(np.clip(rng.normal(200, 40, (112, 140, 3)), 0, 255)
                        .astype(np.uint8), min_pixels=28 * 28,
                        max_pixels=112 * 112)
    ids = _prompt(port_cfg, packed)
    logits = {}
    for value in ("1", ""):
        monkeypatch.setenv("HOCR_TPU_ROPE_FP32", value)
        jax.clear_caches()                    # JAX reads it while tracing
        want = np.asarray(JaxVLModel(jax_params, jax_cfg).forward_logits(
            ids, jnp.asarray(packed.patches[None], jnp.bfloat16),
            packed.grid).astype(jnp.float32))
        got = VLModel(port_params, port_cfg).forward_logits(
            ids, torch.from_numpy(packed.patches[None]).bfloat16(),
            packed.grid).float().numpy()
        assert np.abs(got - want).max() <= BF16_TOL
        logits[value] = (got, want)
        if value != "1":
            continue
        tokenizer = SpellingTokenizer()
        jax_prep = TPUPreprocessor(**PIXELS)
        jax_read = JaxOCRBackend(JaxVLModel(jax_params, jax_cfg), tokenizer,
                                 **PIXELS).read_batch(
            [jax_prep.apply(p, s) for p in pages for s in strategies],
            "Read.", 8)
        prep = TorchPreprocessor(device="cpu", **PIXELS)
        port_read = TorchOCRBackend(
            VLModel(port_params, port_cfg), tokenizer, device="cpu",
            kv_quant=False, **PIXELS).read_batch(
            [prep.apply(p, s) for p in pages for s in strategies], "Read.", 8)
        assert port_read == jax_read
        assert all(len(text.split()) == 8 for text in port_read)
    jax.clear_caches()
    for side in (0, 1):                       # port, JAX
        assert not np.array_equal(logits["1"][side], logits[""][side])


def test_vision_chunk_is_read_from_the_environment():
    """``HOCR_VISION_CHUNK`` sets ``config.SERVE_VISION_CHUNK`` at import,
    in the port as in the JAX package (a fresh interpreter each)."""
    env = {**os.environ, "HOCR_VISION_CHUNK": "1", "JAX_PLATFORMS": "cpu"}
    code = ("import {0}.config as c; print(c.SERVE_VISION_CHUNK)")
    said = [subprocess.run([sys.executable, "-c", code.format(package)],
                           cwd=ROOT, env=env, capture_output=True, text=True,
                           timeout=300, check=True).stdout.strip()
            for package in ("handwritten_ocr_tpu_torch", "handwritten_ocr_tpu")]
    assert said == ["1", "1"]
    assert cfg_mod.SERVE_VISION_CHUNK == int(
        os.environ.get("HOCR_VISION_CHUNK", "8"))


def test_vision_chunk_of_one_gives_the_default_embeds(monkeypatch):
    """Three pages through ``vision_embeds`` in one call of the tower (the
    default chunk, 8) and in three (chunk 1): the same embeddings."""
    _, port_cfg = configs()
    tree = jax.tree_util.tree_map(np.asarray, jax_tree(configs()[0], seed=4))
    model = VLModel(from_jax_params(tree, device="cpu"), port_cfg)
    grid = (1, 8, 12)
    rng = np.random.default_rng(6)
    patches = torch.from_numpy(rng.standard_normal(
        (3, grid[1] * grid[2], 3 * 2 * 14 * 14)).astype(np.float32))
    calls = []
    encode = port_model.vision_encode

    def counted(params, cfg, x, *args):
        calls.append(x.shape[0])
        return encode(params, cfg, x, *args)

    monkeypatch.setattr(port_model, "vision_encode", counted)
    monkeypatch.setattr(cfg_mod, "SERVE_VISION_CHUNK", 8)
    whole = model.vision_embeds(patches, grid)
    monkeypatch.setattr(cfg_mod, "SERVE_VISION_CHUNK", 1)
    chunked = model.vision_embeds(patches, grid)
    assert calls == [3, 1, 1, 1]
    assert chunked.shape == whole.shape == (3, grid[1] * grid[2] // 4, 64)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6)
