"""Shared transformer building blocks (port of ``models/layers.py``).

Numerics follow the JAX package: RMSNorm statistics in fp32 with a cast
back, fp32 softmax, rotary embedding in fp32 (or in bf16 for bf16 inputs,
the fast path). Parameters are plain dicts of tensors in PyTorch's layout:

  linear:  {"w": [out, in], optional "b": [out]}   (JAX stores w as [in, out])
  rmsnorm: {"scale": [dim]}
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(params: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with fp32 statistics (HF Qwen2RMSNorm semantics)."""
    dtype = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (params["scale"] * normed.to(dtype)).to(dtype)


def linear(params: dict, x: torch.Tensor) -> torch.Tensor:
    out = x @ params["w"].t()
    if "b" in params:
        out = out + params["b"]
    return out


def swiglu_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """gate/up/down MLP with a SiLU gate (Qwen2MLP / Qwen2_5_VLMLP)."""
    return linear(params["down"],
                  F.silu(linear(params["gate"], x)) * linear(params["up"], x))


def gelu_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """fc1 → exact GELU → fc2 (vision patch merger MLP)."""
    return linear(params["fc2"],
                  F.gelu(linear(params["fc1"], x), approximate="none"))


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotary application (HF apply_rotary_pos_emb semantics).

    q/k: [..., T, H, D]; cos/sin broadcastable to [..., T, 1, D]. bf16
    inputs compute in bf16 (the fast path, within 1 bf16 ulp of the exact
    result); every other dtype computes in fp32 (the exact path).
    """
    compute = q.dtype if q.dtype == torch.bfloat16 else torch.float32
    qf, kf = q.to(compute), k.to(compute)
    cosf, sinf = cos.to(compute), sin.to(compute)
    q_rot = qf * cosf + rotate_half(qf) * sinf
    k_rot = kf * cosf + rotate_half(kf) * sinf
    return q_rot.to(q.dtype), k_rot.to(k.dtype)


def rope_inv_freq(dim: int, theta: float, device=None) -> torch.Tensor:
    """Standard rotary inverse frequencies for ``dim`` (even)."""
    exponents = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exponents)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor | None, scale: float) -> torch.Tensor:
    """Grouped-query attention with fp32 softmax.

    q: [B, T, Hq, D]; k/v: [B, S, Hkv, D]; mask: bool [B|1, 1, T, S]
    (True = attend) or None. Masked scores take float32's most negative
    value, so an all-masked row averages v uniformly (the flash kernels
    return 0 there instead). Returns [B, T, Hq, D].
    """
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, t, hkv, hq // hkv, d)
    scores = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) * scale
    if mask is not None:
        allowed = mask[:, :, None] if mask.dim() == 4 else mask
        scores = scores.masked_fill(~allowed, torch.finfo(torch.float32).min)
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", weights, v)
    return out.reshape(b, t, hq, d)
