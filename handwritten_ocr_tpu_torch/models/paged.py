"""Paged KV cache: block-pool attention state for continuous batching.

Port of ``handwritten_ocr_tpu/models/paged.py``: full-precision pools, or
int8 pools with per-token, per-head fp32 scale pools (``kv_quant``).

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
    paged_append_attention, quantize_rows)


@dataclasses.dataclass
class PagedKVCache:
    """Block-pool KV state shared by all live sequences (mutable).

    ``k_scale``/``v_scale`` are set only for the int8 cache: the data
    pools then hold int8 rows and the scale pools the per-token, per-head
    fp32 dequantisation factors (amax/127 over D), block size minor.
    """

    k: torch.Tensor             # [L, n_blocks, block_size, H_kv, D]
    v: torch.Tensor             # [L, n_blocks, block_size, H_kv, D]
    block_tables: torch.Tensor  # [S, max_blocks] int32 pool indices (0 = trash)
    lengths: torch.Tensor       # [S] int32 tokens cached per slot
    k_scale: torch.Tensor | None = None   # [L, n_blocks, H_kv, block_size] f32
    v_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def block_size(self) -> int:
        return self.k.shape[2]

    @property
    def max_context(self) -> int:
        return self.block_tables.shape[1] * self.block_size

    @staticmethod
    def block_bytes(num_layers: int, block_size: int, num_kv_heads: int,
                    head_dim: int, dtype=torch.bfloat16,
                    kv_quant: bool = False) -> int:
        """Bytes one pool block takes across layers, k and v (and their
        fp32 scales when ``kv_quant``), as :meth:`zeros` allocates."""
        per_row = (head_dim + 4 if kv_quant
                   else head_dim * torch.empty(0, dtype=dtype).element_size())
        return 2 * num_layers * block_size * num_kv_heads * per_row

    @classmethod
    def zeros(cls, num_layers: int, n_blocks: int, block_size: int,
              n_slots: int, max_blocks: int, num_kv_heads: int,
              head_dim: int, dtype=torch.bfloat16, device="cpu",
              kv_quant: bool = False) -> "PagedKVCache":
        shape = (num_layers, n_blocks, block_size, num_kv_heads, head_dim)
        scales = {}
        if kv_quant:
            dtype = torch.int8
            scale_shape = (num_layers, n_blocks, num_kv_heads, block_size)
            scales = {name: torch.zeros(scale_shape, dtype=torch.float32,
                                        device=device)
                      for name in ("k_scale", "v_scale")}
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            block_tables=torch.zeros((n_slots, max_blocks), dtype=torch.int32,
                                     device=device),
            lengths=torch.zeros((n_slots,), dtype=torch.int32, device=device),
            **scales)


def _write(cache: PagedKVCache, layer_idx: int, tables: torch.Tensor,
           start: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write new ``k/v [B, T, H, D]`` into layer ``layer_idx`` of the pools
    (in place) at positions ``start[b] + t`` of each row's block table;
    int8 pools take the rows of :func:`quantize_rows` and their scales."""
    b, t, h, d = k.shape
    block_size = cache.block_size
    pos = start[:, None].long() + torch.arange(t, device=k.device)[None, :]
    pos = torch.clamp(pos, max=tables.shape[1] * block_size - 1)
    blocks = torch.take_along_dim(tables.long(), pos // block_size, dim=1)
    blocks, offsets = blocks.reshape(-1), (pos % block_size).reshape(-1)
    k, v = k.reshape(b * t, h, d), v.reshape(b * t, h, d)
    if cache.quantized:
        k, k_scales = quantize_rows(k)
        v, v_scales = quantize_rows(v)
        cache.k_scale[layer_idx, blocks, :, offsets] = k_scales
        cache.v_scale[layer_idx, blocks, :, offsets] = v_scales
    cache.k[layer_idx, blocks, offsets] = k.to(cache.k.dtype)
    cache.v[layer_idx, blocks, offsets] = v.to(cache.v.dtype)


def _gather(pool: torch.Tensor, layer_idx: int, tables: torch.Tensor,
            scale_pool: torch.Tensor | None = None) -> torch.Tensor:
    """One layer's cache window for the given rows, dequantised for int8
    pools: [B, max_ctx, H, D]."""
    g = pool[layer_idx][tables.long()]             # [B, MB, BS, H, D]
    if scale_pool is not None:
        scales = scale_pool[layer_idx][tables.long()]      # [B, MB, H, BS]
        g = g.float() * scales.transpose(2, 3)[..., None]
    return g.reshape(g.shape[0], -1, g.shape[-2], g.shape[-1])


def _paged_self_attention(layer: dict, cfg, x: torch.Tensor, cos, sin,
                          layer_idx: int, cache: PagedKVCache,
                          tables: torch.Tensor, start: torch.Tensor,
                          n_valid: torch.Tensor, fresh: bool) -> torch.Tensor:
    """One attention layer over the paged pools.

    x: [B, T, D] current tokens; start[b] = tokens already cached for row
    b; n_valid[b] = how many of this call's T tokens are real (0 = skip
    the row). A fresh prefill (start == 0, T > 1) attends only to itself:
    it writes its k/v and runs causal flash attention on the
    full-precision k/v. A decode-shaped call (T <= 64) runs the fused
    append + paged attention. Qwen3 layers (``q_norm``/``k_norm``) apply
    their RMSNorm over the head dim before the rotary embedding.
    """
    b, t, _ = x.shape
    hd = cfg.head_dim
    q = linear(layer["q"], x).reshape(b, t, cfg.num_attention_heads, hd)
    k = linear(layer["k"], x).reshape(b, t, cfg.num_key_value_heads, hd)
    v = linear(layer["v"], x).reshape(b, t, cfg.num_key_value_heads, hd)
    if "q_norm" in layer:  # Qwen3 QK-norm
        q = rms_norm(layer["q_norm"], q, cfg.rms_norm_eps)
        k = rms_norm(layer["k_norm"], k, cfg.rms_norm_eps)
    q, k = apply_rope(q, k, cos[:, :, None, :], sin[:, :, None, :])

    if fresh and t > 1:
        # Right-padded garbage rows self-attend harmlessly; their outputs
        # are never read.
        _write(cache, layer_idx, tables, start, k, v)
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=True, scale=hd ** -0.5)
        return linear(layer["o"], out.reshape(b, t, -1))

    if t <= 64 and not (cache.quantized and t > cache.block_size):
        # Decode steps (T == 1): query token i attends through absolute
        # position start + i. int8 pools take the new rows in x's dtype
        # (the kernel quantises them); fp pools in the pool's dtype.
        kv_dtype = x.dtype if cache.quantized else cache.k.dtype
        out = paged_append_attention(
            q.contiguous(), k.to(kv_dtype).contiguous(),
            v.to(kv_dtype).contiguous(), cache.k, cache.v, tables,
            start, n_valid, cache.k_scale, cache.v_scale, layer=layer_idx,
            scale=hd ** -0.5)
        return linear(layer["o"], out.to(x.dtype).reshape(b, t, -1))

    _write(cache, layer_idx, tables, start, k, v)
    keys = _gather(cache.k, layer_idx, tables, cache.k_scale)
    values = _gather(cache.v, layer_idx, tables, cache.v_scale)
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
        # once per step, not once per layer in the paged kernel's wrapper
        tables = tables[:, :table_pages].contiguous()
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
