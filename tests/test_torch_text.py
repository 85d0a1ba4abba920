"""Text side of the port against the JAX package: M-RoPE, the prompt's
position ids, the image splice and the paged decoder stack.

fp32 weights and inputs from a seed. Position ids are integers (equal);
rotary tables agree within 1e-6; hidden states through two decoder
layers within 1e-4 (fp32, another summation order). Only rows the callers
read are compared: prefill rows below each prompt's length, decode rows
of live slots, and the pool rows that live slots wrote.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from torch_port_tiny import configs, jax_tree, port_tree
from handwritten_ocr_tpu.models.paged import (
    PagedKVCache as JaxCache, paged_forward as jax_paged_forward)
from handwritten_ocr_tpu.models.qwen25vl.language import (
    mrope_cos_sin as jax_mrope)
from handwritten_ocr_tpu.models.qwen25vl.model import (
    VLModel as JaxVLModel, rope_index_for_prompt as jax_rope_index)
from handwritten_ocr_tpu_torch.models.paged import PagedKVCache, paged_forward
from handwritten_ocr_tpu_torch.models.qwen25vl.language import mrope_cos_sin
from handwritten_ocr_tpu_torch.models.qwen25vl.model import (
    VLModel, rope_index_for_prompt)
from handwritten_ocr_tpu_torch.models.processor import (ByteTokenizer,
                                                        vlm_chat_prompt)

GRID = (1, 8, 12)


def prompt_ids(cfg, grid=GRID):
    n_image = grid[0] * grid[1] * grid[2] // 4
    return np.array(ByteTokenizer().encode(
        vlm_chat_prompt("Read.", num_image_tokens=n_image)), np.int32)


def test_rope_index_for_prompt():
    jax_cfg, port_cfg = configs()
    ids = prompt_ids(port_cfg)
    want_pos, want_delta = jax_rope_index(ids, jax_cfg, [GRID])
    got_pos, got_delta = rope_index_for_prompt(ids, port_cfg, [GRID])
    np.testing.assert_array_equal(got_pos, want_pos)
    assert got_delta == want_delta and got_delta < 0


def test_mrope_cos_sin_both_forms():
    jax_cfg, port_cfg = configs()
    rng = np.random.default_rng(0)
    for shape in ((3, 2, 9), (2, 9)):
        pos = rng.integers(0, 3000, shape).astype(np.int32)
        want = jax_mrope(jax_cfg.text, jnp.asarray(pos))
        got = mrope_cos_sin(port_cfg.text, torch.from_numpy(pos))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_prompt_embeds_splice():
    jax_cfg, port_cfg = configs()
    tree = jax_tree(jax_cfg, seed=6)
    ids = np.tile(prompt_ids(port_cfg), (2, 1))
    rng = np.random.default_rng(1)
    patches = rng.standard_normal((2, 96, 1176)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(JaxVLModel(tree, jax_cfg).prompt_embeds(
            tree, jnp.asarray(ids), jnp.asarray(patches), GRID))
    model = VLModel(port_tree(jax.tree_util.tree_map(np.asarray, tree)),
                    port_cfg)
    got = model.prompt_embeds(torch.from_numpy(ids).long(),
                              torch.from_numpy(patches), GRID).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    text_rows = ids[0] != port_cfg.image_token_id
    np.testing.assert_array_equal(got[:, text_rows], want[:, text_rows])


class PagedPair:
    """The same paged cache on both sides, driven call by call."""

    def __init__(self, seed, n_slots, bs, max_blocks, tables):
        jax_cfg, port_cfg = configs(vocab_size=300)
        self.jax_cfg = jax_cfg.text
        self.cfg = port_cfg.text
        self.jax_text = jax_tree(jax_cfg, seed=seed)["text"]
        self.port_text = port_tree(
            jax.tree_util.tree_map(np.asarray, self.jax_text))
        cfg = self.cfg
        dims = (cfg.num_hidden_layers, 1 + n_slots * max_blocks, bs, n_slots,
                max_blocks, cfg.num_key_value_heads, cfg.head_dim)
        self.jcache = JaxCache.zeros(*dims, dtype=jnp.float32)._replace(
            block_tables=jnp.asarray(tables))
        self.tcache = PagedKVCache.zeros(*dims, dtype=torch.float32)
        self.tcache.block_tables.copy_(torch.from_numpy(tables))

    def forward(self, embeds, pos, slots, start, new_len, **kw):
        """(port hidden, JAX hidden) of one paged_forward call."""
        with jax.default_matmul_precision("highest"):
            want, self.jcache = jax_paged_forward(
                self.jax_text, self.jax_cfg, jnp.asarray(embeds),
                jnp.asarray(pos), self.jcache, jnp.asarray(slots),
                jnp.asarray(start), jnp.asarray(new_len),
                **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                   for k, v in kw.items()})
        got = paged_forward(
            self.port_text, self.cfg, torch.from_numpy(embeds),
            torch.from_numpy(pos), self.tcache,
            torch.from_numpy(slots).long(), torch.from_numpy(start),
            torch.from_numpy(new_len),
            **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()})
        return got.numpy(), np.asarray(want)

    def assert_pools_equal(self, tables, slots, bs):
        """The pool rows each slot's cached tokens occupy agree."""
        for slot in slots:
            n = int(self.tcache.lengths[slot])
            blocks = tables[slot, np.arange(n) // bs]
            offsets = np.arange(n) % bs
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    getattr(self.tcache, name).numpy()[:, blocks, offsets],
                    np.asarray(getattr(self.jcache, name))[:, blocks, offsets],
                    rtol=1e-4, atol=1e-4)


def prefill(pair, rng, slots, true_len, bucket):
    embeds = rng.standard_normal(
        (len(slots), bucket, pair.cfg.hidden_size)).astype(np.float32)
    pos = np.broadcast_to(np.arange(bucket),
                          (3, len(slots), bucket)).astype(np.int32)
    got, want = pair.forward(embeds, pos, slots, np.zeros(len(slots), np.int32),
                             true_len, fresh=True)
    for row, n in enumerate(true_len):
        np.testing.assert_allclose(got[row, :n], want[row, :n],
                                   rtol=1e-4, atol=1e-4)


def test_paged_forward_prefill_then_three_decode_steps():
    n_slots, bs, max_blocks = 3, 8, 6
    tables = np.zeros((n_slots, max_blocks), np.int32)
    tables[0, :3] = [4, 9, 2]
    tables[2, :3] = [7, 1, 12]
    pair = PagedPair(8, n_slots, bs, max_blocks, tables)
    rng = np.random.default_rng(2)
    prefill(pair, rng, np.array([2, 0], np.int32), np.array([13, 7], np.int32),
            16)

    live = np.array([True, False, True])
    all_slots = np.arange(n_slots, dtype=np.int32)
    for step in range(3):
        start = np.array(pair.tcache.lengths.numpy())
        np.testing.assert_array_equal(start, np.asarray(pair.jcache.lengths))
        step_embeds = rng.standard_normal(
            (n_slots, 1, pair.cfg.hidden_size)).astype(np.float32)
        step_pos = np.broadcast_to(start[None, :, None],
                                   (3, n_slots, 1)).astype(np.int32)
        got, want = pair.forward(step_embeds, step_pos, all_slots, start,
                                 (start + 1).astype(np.int32), attn_valid=live)
        np.testing.assert_allclose(got[live], want[live], rtol=1e-4, atol=1e-4)
    pair.assert_pools_equal(tables, (0, 2), bs)


def test_paged_forward_long_continuation_gathers_the_cache():
    """A non-fresh call of more than 64 tokens (a prompt continued after
    its first chunk) writes through the tables, gathers each slot's pages
    and attends by absolute position."""
    n_slots, bs, max_blocks = 2, 8, 12
    tables = np.zeros((n_slots, max_blocks), np.int32)
    tables[0, :11] = [5, 3, 17, 8, 1, 22, 14, 2, 9, 20, 11]
    tables[1, :11] = [4, 6, 7, 10, 12, 13, 15, 16, 18, 19, 21]
    pair = PagedPair(9, n_slots, bs, max_blocks, tables)
    rng = np.random.default_rng(3)
    slots = np.array([0, 1], np.int32)
    prefill(pair, rng, slots, np.array([11, 6], np.int32), 16)

    t = 72
    start = np.array(pair.tcache.lengths.numpy())
    embeds = rng.standard_normal((2, t, pair.cfg.hidden_size)).astype(np.float32)
    pos = np.broadcast_to((start[:, None] + np.arange(t))[None],
                          (3, 2, t)).astype(np.int32)
    got, want = pair.forward(embeds, pos, slots, start,
                             (start + t).astype(np.int32))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    pair.assert_pools_equal(tables, (0, 1), bs)
