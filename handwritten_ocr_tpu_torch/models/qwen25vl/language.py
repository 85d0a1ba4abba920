"""Qwen2.5-VL text decoder pieces: M-RoPE tables and the LM head.

Port of ``mrope_cos_sin`` and ``lm_logits`` from
``handwritten_ocr_tpu/models/qwen25vl/language.py``. The decoder stack
itself runs over the paged cache (``models/paged.py``).

M-RoPE: position ids are [3, B, T] (temporal, height, width planes); the
rotary half-dim is cut by ``mrope_section`` with plane ``i % 3`` supplying
chunk ``i``. Text tokens carry equal ids in all planes.
"""

from __future__ import annotations

import torch

from handwritten_ocr_tpu_torch.models.layers import rope_inv_freq
from handwritten_ocr_tpu_torch.models.qwen25vl.config import TextConfig


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


def lm_logits(params: dict, cfg: TextConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Final hidden states [B, T, D] → fp32 vocabulary logits [B, T, V].

    The product accumulates in fp32 and is not rounded to the hidden
    dtype, so the greedy argmax sees fp32 logits. A plain matrix product
    outside any kernel, as the JAX package leaves it to XLA.
    """
    w = params["embed"]["w"] if cfg.tie_word_embeddings else params["lm_head"]["w"]
    b, t, d = hidden.shape
    flat = hidden.reshape(b * t, d)
    if hidden.dtype == torch.float32:
        logits = flat @ w.float().t()
    elif hidden.is_cuda:
        logits = torch.mm(flat, w.t(), out_dtype=torch.float32)
    else:  # reduced precision on the CPU: widen, then multiply
        logits = flat.float() @ w.float().t()
    return logits.reshape(b, t, -1)
