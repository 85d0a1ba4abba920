"""Weight-only int8 quantisation (per-output-channel absmax).

Port of ``handwritten_ocr_tpu/models/quant.py``. Every projection weight
of the attention and MLP stacks, and the lm_head, is stored as int8 with
a float32 scale per output channel (absmax / 127 over the input axis);
embeddings, norms and biases keep their dtype. In the port's ``[out, in]``
layout the input axis is the LAST axis, so ``w_q`` is ``[out, in]`` int8
and ``w_scale`` ``[out]`` float32: the same numbers as the JAX package's
``[in, out]`` tree, transposed.

A decode step reads every weight once, so int8 halves its weight bytes;
``models/layers.py:linear`` and ``lm_logits`` take the ``w_q`` branch.
"""

from __future__ import annotations

from typing import Any

import torch

# Leaf dict keys of the projections to quantise (the JAX package's set).
_QUANT_PARENTS = {"q", "k", "v", "o", "qkv", "proj", "gate", "up", "down",
                  "fc1", "fc2", "lm_head"}


def _quantize_linear(linear_params: dict) -> dict:
    """``{"w": [out, in]}`` (optionally with ``"b"``) → ``{"w_q": int8
    [out, in], "w_scale": float32 [out]}``: scale = max(absmax, 1e-8) / 127
    per output channel, w_q = clip(round-half-even(w / scale), ±127)."""
    w = linear_params["w"].float()
    absmax = w.abs().amax(dim=-1, keepdim=True)               # [out, 1]
    # A tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the rounded quotient.
    scale = torch.clamp_min(absmax, 1e-8) / w.new_full((), 127.0)
    w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    out = {"w_q": w_q, "w_scale": scale.squeeze(-1)}
    if "b" in linear_params:
        out["b"] = linear_params["b"]
    return out


def quantize_tree(params: Any) -> Any:
    """Quantise every projection of a parameter tree (dicts and lists)."""
    if isinstance(params, dict):
        out = {}
        for key, value in params.items():
            if (isinstance(value, dict) and key in _QUANT_PARENTS
                    and "w" in value and value["w"].dim() == 2):
                out[key] = _quantize_linear(value)
            else:
                out[key] = quantize_tree(value)
        return out
    if isinstance(params, list):
        return [quantize_tree(v) for v in params]
    return params


def dequantize_weight(linear_params: dict,
                      dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The full-precision weight ``[out, in]`` (inspection only)."""
    return (linear_params["w_q"].float()
            * linear_params["w_scale"][:, None]).to(dtype)


def quantized_bytes(params: Any) -> int:
    """Bytes of every tensor of a parameter tree (reporting helper)."""
    if isinstance(params, dict):
        return sum(quantized_bytes(v) for v in params.values())
    if isinstance(params, list):
        return sum(quantized_bytes(v) for v in params)
    return params.numel() * params.element_size()
