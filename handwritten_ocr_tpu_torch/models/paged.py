"""Paged KV cache: block-pool attention state for continuous batching.

Port of ``handwritten_ocr_tpu/models/paged.py`` with full-precision pools.

- One shared block pool ``[L, n_blocks, block_size, H_kv, D]`` per k and v
  holds every live sequence's keys/values (page-major: a page is one
  contiguous ``[block_size, H_kv, D]`` slab).
- Slots: a fixed decode batch of S slots; slot s owns row s of
  ``block_tables [S, max_blocks]`` (logical block -> pool block).
- Pool block 0 is a reserved trash sink: free slots' tables are all zeros,
  so their masked, never-read writes land somewhere harmless.

Unlike the JAX package, the cache is mutated in place: :func:`paged_forward`
writes the new k/v rows into the pools and the lengths into ``lengths``.
"""

from __future__ import annotations

import dataclasses

import torch

from handwritten_ocr_tpu_torch.models.layers import (apply_rope, attention,
                                                     linear, rms_norm,
                                                     swiglu_mlp)
from handwritten_ocr_tpu_torch.models.qwen25vl.language import mrope_cos_sin
from handwritten_ocr_tpu_torch.ops.flash_attention import flash_attention
from handwritten_ocr_tpu_torch.ops.paged_decode_attention import (
    paged_append_attention)


@dataclasses.dataclass
class PagedKVCache:
    """Block-pool KV state shared by all live sequences (mutable)."""

    k: torch.Tensor             # [L, n_blocks, block_size, H_kv, D]
    v: torch.Tensor             # [L, n_blocks, block_size, H_kv, D]
    block_tables: torch.Tensor  # [S, max_blocks] int32 pool indices (0 = trash)
    lengths: torch.Tensor       # [S] int32 tokens cached per slot

    @property
    def block_size(self) -> int:
        return self.k.shape[2]

    @property
    def max_context(self) -> int:
        return self.block_tables.shape[1] * self.block_size

    @classmethod
    def zeros(cls, num_layers: int, n_blocks: int, block_size: int,
              n_slots: int, max_blocks: int, num_kv_heads: int,
              head_dim: int, dtype=torch.bfloat16,
              device="cpu") -> "PagedKVCache":
        shape = (num_layers, n_blocks, block_size, num_kv_heads, head_dim)
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            block_tables=torch.zeros((n_slots, max_blocks), dtype=torch.int32,
                                     device=device),
            lengths=torch.zeros((n_slots,), dtype=torch.int32, device=device),
        )


def _write(k_pool: torch.Tensor, v_pool: torch.Tensor, layer_idx: int,
           tables: torch.Tensor, start: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor) -> None:
    """Write new ``k/v [B, T, H, D]`` into layer ``layer_idx`` of the pools
    (in place) at positions ``start[b] + t`` of each row's block table."""
    b, t, h, d = k.shape
    block_size = k_pool.shape[2]
    pos = start[:, None].long() + torch.arange(t, device=k.device)[None, :]
    pos = torch.clamp(pos, max=tables.shape[1] * block_size - 1)
    blocks = torch.take_along_dim(tables.long(), pos // block_size, dim=1)
    blocks, offsets = blocks.reshape(-1), (pos % block_size).reshape(-1)
    k_pool[layer_idx, blocks, offsets] = k.reshape(b * t, h, d).to(k_pool.dtype)
    v_pool[layer_idx, blocks, offsets] = v.reshape(b * t, h, d).to(v_pool.dtype)


def _gather(pool: torch.Tensor, layer_idx: int,
            tables: torch.Tensor) -> torch.Tensor:
    """One layer's cache window for the given rows: [B, max_ctx, H, D]."""
    g = pool[layer_idx][tables.long()]             # [B, MB, BS, H, D]
    return g.reshape(g.shape[0], -1, g.shape[-2], g.shape[-1])


def _paged_self_attention(layer: dict, cfg, x: torch.Tensor, cos, sin,
                          layer_idx: int, cache: PagedKVCache,
                          tables: torch.Tensor, start: torch.Tensor,
                          n_valid: torch.Tensor, fresh: bool) -> torch.Tensor:
    """One attention layer over the paged pools.

    x: [B, T, D] current tokens; start[b] = tokens already cached for row
    b; n_valid[b] = how many of this call's T tokens are real (0 = skip
    the row). A fresh prefill (start == 0, T > 1) attends only to itself:
    it writes its k/v and runs causal flash attention on them. A
    decode-shaped call (T <= 64) runs the fused append + paged attention.
    """
    b, t, _ = x.shape
    hd = cfg.head_dim
    q = linear(layer["q"], x).reshape(b, t, cfg.num_attention_heads, hd)
    k = linear(layer["k"], x).reshape(b, t, cfg.num_key_value_heads, hd)
    v = linear(layer["v"], x).reshape(b, t, cfg.num_key_value_heads, hd)
    q, k = apply_rope(q, k, cos[:, :, None, :], sin[:, :, None, :])

    if fresh and t > 1:
        # Right-padded garbage rows self-attend harmlessly; their outputs
        # are never read.
        _write(cache.k, cache.v, layer_idx, tables, start, k, v)
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=True, scale=hd ** -0.5)
        return linear(layer["o"], out.reshape(b, t, -1))

    if t <= 64:
        # Decode steps (T == 1): query token i attends through absolute
        # position start + i.
        out = paged_append_attention(
            q.contiguous(), k.to(cache.k.dtype).contiguous(),
            v.to(cache.v.dtype).contiguous(), cache.k, cache.v, tables,
            start, n_valid, layer=layer_idx, scale=hd ** -0.5)
        return linear(layer["o"], out.to(x.dtype).reshape(b, t, -1))

    _write(cache.k, cache.v, layer_idx, tables, start, k, v)
    keys = _gather(cache.k, layer_idx, tables)
    values = _gather(cache.v, layer_idx, tables)
    rows = start[:, None, None].long() + torch.arange(t, device=x.device)[None, :, None]
    cols = torch.arange(keys.shape[1], device=x.device)[None, None, :]
    mask = (cols <= rows)[:, None]                               # [B, 1, T, CTX]
    out = attention(q, keys.to(q.dtype), values.to(q.dtype), mask,
                    scale=hd ** -0.5)
    return linear(layer["o"], out.reshape(b, t, -1))


def paged_forward(params: dict, cfg, embeds: torch.Tensor,
                  position_ids: torch.Tensor, cache: PagedKVCache,
                  slot_ids: torch.Tensor, start: torch.Tensor,
                  new_len: torch.Tensor, fresh: bool = False,
                  attn_valid: torch.Tensor | None = None,
                  table_pages: int | None = None) -> torch.Tensor:
    """Decoder stack over ``embeds [B, T, D]`` with the paged cache;
    returns the final-normed hidden states and updates ``cache`` in place.

    slot_ids [B]: the cache slot of each row; start [B]: tokens already
    cached per row (0 for a fresh prefill); new_len [B]: the length to
    record for each slot afterwards. ``fresh`` asserts start == 0 for
    every row. attn_valid (optional): bool [B] rows whose output is
    consumed; the others append nothing and skip their attention.
    table_pages (optional): attend over only the first N pages of each
    slot's table; callers keep every valid row's length below
    ``table_pages * block_size``.
    """
    tables = cache.block_tables[slot_ids]
    if table_pages is not None and table_pages < tables.shape[1]:
        tables = tables[:, :table_pages]
    if attn_valid is None:
        n_valid = new_len - start
    else:
        n_valid = torch.where(attn_valid, new_len - start,
                              torch.zeros_like(start))
    cos, sin = mrope_cos_sin(cfg, position_ids)
    x = embeds
    for idx, layer in enumerate(params["layers"]):
        x = x + _paged_self_attention(
            layer["attn"], cfg, rms_norm(layer["ln1"], x, cfg.rms_norm_eps),
            cos, sin, idx, cache, tables, start, n_valid, fresh)
        x = x + swiglu_mlp(layer["mlp"], rms_norm(layer["ln2"], x, cfg.rms_norm_eps))
    x = rms_norm(params["final_norm"], x, cfg.rms_norm_eps)
    cache.lengths[slot_ids] = torch.clamp(new_len, max=cache.max_context).to(torch.int32)
    return x
