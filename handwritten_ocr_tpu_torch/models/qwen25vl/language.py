"""Qwen2.5-VL text decoder: M-RoPE tables, the dense decoder stack over a
contiguous KV cache, and the LM head.

Port of ``handwritten_ocr_tpu/models/qwen25vl/language.py``. The serving
path runs the same layers over the paged cache (``models/paged.py``);
:func:`text_forward` over a :class:`KVCache` is the dense path
(``HOCR_VL_SERVING`` / ``HOCR_LLM_SERVING`` = ``dense``) and the parity
entry point (``forward_logits``, no cache).

M-RoPE: position ids are [3, B, T] (temporal, height, width planes); the
rotary half-dim is cut by ``mrope_section`` with plane ``i % 3`` supplying
chunk ``i``. Text tokens carry equal ids in all planes.

Under tensor parallelism (``group``, a rank's "model" process group) a
rank runs its H/tp query and Hkv/tp kv heads (the head counts follow the
weights' widths), its cache holds its kv heads, and its logits are its
vocab shard. The replicated activations enter q/k/v, gate/up and the LM
head through Megatron's "f" (``parallel/collectives.py``). Under FSDP
(``gather``, ``parallel/sharding.py:LayerGather``) each layer's "data"
blocks are gathered just before the layer runs.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from handwritten_ocr_tpu_torch.models.layers import (apply_rope, argmax_ids,
                                                     attention, linear,
                                                     rms_norm, rope_inv_freq,
                                                     swiglu_mlp)
from handwritten_ocr_tpu_torch.models.qwen25vl.config import TextConfig
from handwritten_ocr_tpu_torch.ops.flash_attention import flash_attention
from handwritten_ocr_tpu_torch.ops.int8_matmul import MAX_ROWS, int8_matmul
from handwritten_ocr_tpu_torch.parallel.collectives import copy_to_group
from handwritten_ocr_tpu_torch.parallel.sharding import gathered

# The masked attention of the dense path runs in query chunks whose fp32
# scores stay within this many bytes (a left-padded 2.8k-token prefill of
# 8 rows over a 6.9k-token cache would otherwise take ~40 GB).
SCORE_BYTES = 2 ** 30


@dataclasses.dataclass
class KVCache:
    """Contiguous per-layer keys and values and the write cursor (the
    number of tokens already cached). Mutated in place by
    :func:`text_forward`, where the JAX package returns a new cache."""

    k: torch.Tensor     # [L, B, S_max, H_kv, D]
    v: torch.Tensor     # [L, B, S_max, H_kv, D]
    cursor: int = 0

    @classmethod
    def zeros(cls, num_layers: int, batch: int, max_len: int,
              num_kv_heads: int, head_dim: int, dtype=torch.bfloat16,
              device="cpu") -> "KVCache":
        shape = (num_layers, batch, max_len, num_kv_heads, head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def mrope_cos_sin(cfg: TextConfig, position_ids: torch.Tensor):
    """cos/sin [B, T, head_dim] (fp32) for rotary embedding.

    position_ids [3, B, T] → M-RoPE via cfg.mrope_section;
    position_ids [B, T] → standard 1D RoPE.
    """
    inv_freq = rope_inv_freq(cfg.head_dim, cfg.rope_theta,
                             device=position_ids.device)
    freqs = position_ids[..., None].float() * inv_freq
    if position_ids.dim() == 2:
        half = freqs
    else:
        chunks = []
        start = 0
        for i, section in enumerate(cfg.mrope_section):
            chunks.append(freqs[i % 3, :, :, start:start + section])
            start += section
        half = torch.cat(chunks, dim=-1)
    emb = torch.cat([half, half], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _chunked_attention(q, k, v, mask, scale: float) -> torch.Tensor:
    """``layers.attention`` in chunks of query tokens whose fp32 scores
    stay within SCORE_BYTES; each query row's softmax is its own, so the
    chunks change nothing but the peak memory."""
    b, t, hq, _ = q.shape
    step = max(1, SCORE_BYTES // (b * hq * k.shape[1] * 4))
    if step >= t:
        return attention(q, k, v, mask, scale)
    return torch.cat([attention(q[:, i:i + step], k, v,
                                mask[:, :, i:i + step], scale)
                      for i in range(0, t, step)], dim=1)


def _self_attention(layer: dict, cfg: TextConfig, x: torch.Tensor, cos,
                    sin, layer_idx: int, cache: KVCache | None,
                    key_padding: torch.Tensor | None,
                    group=None) -> torch.Tensor:
    """One attention layer of the dense stack: x [B, T, D]; the new k/v
    go into ``cache`` at its cursor. T > 1 without key padding is a
    prefill into an empty cache and runs causal flash attention over the
    current tokens; anything else runs the plain masked attention over
    the whole cache (or the current tokens without one), causal by
    position and ANDed with ``key_padding`` [B, S] (True = a real key)."""
    b, t, _ = x.shape
    hd = cfg.head_dim
    x = copy_to_group(x, group)
    q = linear(layer["q"], x).reshape(b, t, -1, hd)
    k = linear(layer["k"], x).reshape(b, t, -1, hd)
    v = linear(layer["v"], x).reshape(b, t, -1, hd)
    if "q_norm" in layer:  # Qwen3: RMSNorm over the head dim before rotary
        q = rms_norm(layer["q_norm"], q, cfg.rms_norm_eps)
        k = rms_norm(layer["k_norm"], k, cfg.rms_norm_eps)
    q, k = apply_rope(q, k, cos[:, :, None, :], sin[:, :, None, :])

    if cache is not None:
        end = cache.cursor + t
        cache.k[layer_idx, :, cache.cursor:end] = k.to(cache.k.dtype)
        cache.v[layer_idx, :, cache.cursor:end] = v.to(cache.v.dtype)
    if t > 1 and key_padding is None:
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=True, scale=hd ** -0.5)
        return linear(layer["o"], out.reshape(b, t, -1), group)

    rows = torch.arange(t, device=x.device)[:, None]
    if cache is None:
        keys, values = k, v
    else:
        keys, values = cache.k[layer_idx], cache.v[layer_idx]
        rows = rows + cache.cursor
    cols = torch.arange(keys.shape[1], device=x.device)[None, :]
    mask = (cols <= rows)[None, None]                       # [1, 1, T, S]
    if key_padding is not None:
        mask = mask & key_padding[:, None, None, :]
    out = _chunked_attention(q, keys.to(q.dtype), values.to(q.dtype), mask,
                             hd ** -0.5)
    return linear(layer["o"], out.reshape(b, t, -1), group)


def text_forward(params: dict, cfg: TextConfig, embeds: torch.Tensor,
                 position_ids: torch.Tensor, cache: KVCache | None = None,
                 key_padding: torch.Tensor | None = None, group=None,
                 gather=None) -> tuple[torch.Tensor, KVCache | None]:
    """Dense decoder stack over ``embeds [B, T, D]`` at ``position_ids``
    ([3, B, T] M-RoPE or [B, T] 1D); key_padding: optional bool [B, S]
    valid-key mask (S = the cache length, or T without a cache); group:
    the model group under TP; gather: the text tree's FSDP gather (None
    without FSDP). Returns (final-normed hidden [B, T, D], the cache,
    advanced by T in place)."""
    cos, sin = mrope_cos_sin(cfg, position_ids)
    x = embeds
    for idx, layer in enumerate(params["layers"]):
        layer = gathered(gather, layer, "layers", idx)
        x = x + _self_attention(
            layer["attn"], cfg, rms_norm(layer["ln1"], x, cfg.rms_norm_eps),
            cos, sin, idx, cache, key_padding, group)
        x = x + swiglu_mlp(layer["mlp"],
                           rms_norm(layer["ln2"], x, cfg.rms_norm_eps), group)
    if cache is not None:
        cache.cursor += embeds.shape[1]
    final_norm = gathered(gather, params["final_norm"], "final_norm")
    return rms_norm(final_norm, x, cfg.rms_norm_eps), cache


class GenerationResult(NamedTuple):
    tokens: torch.Tensor    # [B, max_new] int32; EOS after a row's end
    lengths: torch.Tensor   # [B] generated tokens before the first EOS


def greedy_decode(step_logits, first: torch.Tensor, max_new: int,
                  eos: int, group=None) -> GenerationResult:
    """The dense path's decode loop: from ``first [B]`` (the prefill's
    tokens), ``step_logits(step, previous tokens [B])`` gives each step's
    fp32 logits [B, V], until every row emitted EOS or ``max_new`` tokens
    stand (one host read of a flag per step). A done row takes EOS; the
    columns after the last step stay 0, as in the JAX loop. Under TP the
    logits are the rank's vocab shard and ``group`` its model group."""
    tokens = torch.zeros((first.shape[0], max_new), dtype=torch.int32,
                         device=first.device)
    tokens[:, 0] = first
    done = first == eos
    for step in range(1, max_new):
        if bool(done.all()):
            break
        nxt = argmax_ids(step_logits(step, tokens[:, step - 1]), group)
        nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
        tokens[:, step] = nxt
        done = done | (nxt == eos)
    lengths = torch.cumprod((tokens != eos).to(torch.int32), dim=1).sum(dim=1)
    return GenerationResult(tokens=tokens, lengths=lengths)


def lm_logits(params: dict, cfg: TextConfig, hidden: torch.Tensor,
              group=None, gather=None) -> torch.Tensor:
    """Final hidden states [B, T, D] → fp32 vocabulary logits [B, T, V]
    (under TP, the rank's vocab shard [B, T, V/tp]: the head is split by
    output rows, a tied head by the embedding's; ``group``, the model
    group, is needed only to differentiate it: the replicated hidden
    states enter the head through "f"). ``gather``: the text tree's FSDP
    gather.

    The product accumulates in fp32 and is not rounded to the hidden
    dtype, so the greedy argmax sees fp32 logits. A plain matrix product
    outside any kernel, as the JAX package leaves it to XLA; differentiable
    in bf16 on the card through :class:`_Fp32Product`.

    An int8 head (``models/quant.py``) at b·t ≤ 32 rows goes to the int8
    kernel with fp32 output (the head is the largest single weight read of
    a decode step); more rows take the fp32-accumulated product of the
    widened weight, times the scale in fp32.
    """
    b, t, d = hidden.shape
    flat = copy_to_group(hidden, group).reshape(b * t, d)
    key = "embed" if cfg.tie_word_embeddings else "lm_head"
    head = gathered(gather, params[key], key)
    if not cfg.tie_word_embeddings and "w_q" in head:
        if b * t <= MAX_ROWS:
            logits = int8_matmul(flat.contiguous(), head["w_q"],
                                 head["w_scale"], out_dtype=torch.float32)
        else:
            logits = (_fp32_product(flat, head["w_q"].to(hidden.dtype))
                      * head["w_scale"])
        return logits.reshape(b, t, -1)
    return _fp32_product(flat, head["w"]).reshape(b, t, -1)


class _Fp32Product(torch.autograd.Function):
    """``flat @ w^T`` of reduced-precision operands with fp32 output, as
    XLA's dot with ``preferred_element_type=f32``: the forward accumulates
    in fp32 and does not round; the backward takes the fp32 cotangent
    rounded to the operands' dtype and returns gradients in that dtype
    (products accumulated in fp32 by cuBLAS)."""

    @staticmethod
    def forward(ctx, flat, w):
        ctx.save_for_backward(flat, w)
        return torch.mm(flat, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        flat, w = ctx.saved_tensors
        grad = grad.to(flat.dtype)
        d_flat = grad @ w if ctx.needs_input_grad[0] else None
        d_w = grad.t() @ flat if ctx.needs_input_grad[1] else None
        return d_flat, d_w


def _fp32_product(flat: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``flat [M, D] @ w [V, D]^T``, summed and returned in fp32."""
    if flat.dtype == torch.float32:
        return flat @ w.float().t()
    if flat.is_cuda:
        return _Fp32Product.apply(flat, w)
    return flat.float() @ w.float().t()   # reduced precision on the CPU
