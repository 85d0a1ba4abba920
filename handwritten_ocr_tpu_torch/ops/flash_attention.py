"""Flash attention: GQA online-softmax attention, optionally causal.

Port of ``handwritten_ocr_tpu/ops/flash_attention.py``. CUDA tensors go to
the hand-written kernel ``csrc/flash_attention.cu``; CPU tensors to
:func:`flash_attention_plain`, which does the same arithmetic in PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from handwritten_ocr_tpu_torch.ops import build
from handwritten_ocr_tpu_torch.ops.dispatch import check, use_kernel

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (80, 128)     # vision and text head widths


def _normalize_mask(kv_mask: torch.Tensor | None, b: int, s: int,
                    device) -> torch.Tensor | None:
    """``None`` or a ``[1|B, S]`` uint8 tensor (nonzero = key is valid)."""
    if kv_mask is None:
        return None
    mask = kv_mask.to(device=device)
    if mask.dim() == 1:
        mask = mask[None]
    check(mask.dim() == 2 and mask.shape[1] == s
          and mask.shape[0] in (1, b), f"kv_mask must be [S] or [B, S], got "
          f"{tuple(kv_mask.shape)}")
    return (mask != 0).to(torch.uint8).contiguous()


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_mask: torch.Tensor | None = None, *,
                          causal: bool = False,
                          scale: float | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 scores, masked keys at
    -inf, the all-masked-row guard (that row returns 0), P rounded to v's
    dtype before the P.V product, fp32 accumulation."""
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5
    qf = q.float().reshape(b, t, hkv, group, d)
    scores = torch.einsum("bthgd,bshd->bhgts", qf, k.float()) * scale
    mask = _normalize_mask(kv_mask, b, s, q.device)
    allowed = torch.ones((1, s), dtype=torch.bool, device=q.device) \
        if mask is None else mask.bool()
    allowed = allowed.reshape(-1, 1, 1, 1, s)
    if causal:
        rows = torch.arange(t, device=q.device)[:, None]
        cols = torch.arange(s, device=q.device)[None, :]
        allowed = allowed & (cols <= rows)
    scores = scores.masked_fill(~allowed, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(scores - m).masked_fill(~allowed, 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    pv = torch.einsum("bhgts,bshd->bthgd", p.to(v.dtype).float(), v.float())
    out = pv / denom.permute(0, 3, 1, 2, 4)
    return out.reshape(b, t, hq, d).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: torch.Tensor | None = None, *,
                    causal: bool = False,
                    scale: float | None = None) -> torch.Tensor:
    """Fused attention; q ``[B, T, Hq, D]``, k/v ``[B, S, Hkv, D]``,
    kv_mask ``[S]`` or ``[B, S]`` (nonzero = valid key); returns
    ``[B, T, Hq, D]`` in q's dtype.

    Replaces the TPU kernel ``handwritten_ocr_tpu/ops/flash_attention.py:
    _flash_kernel``. On the H100 it is bound by operations: at the vision
    global layers (q, k, v ``[8, 3456, 16, 80]`` bf16) it does 4·T·S·D
    flops per head, ~2 TFLOP per 4 layers, against ~0.1 GB of inputs; the
    causal prefill (``[8, ~1k, 28, 128]``) is the same shape of problem.
    The kernel never writes scores to device memory, skips key tiles
    above the causal diagonal, and reads each K/V tile once per 64-row q
    tile. bf16 inputs run both products on the tensor cores
    (``mma.sync`` bf16 → fp32) with the scores and P held in registers;
    fp32 inputs run a plain FMA body.
    """
    b, t, hq, d = q.shape
    check(k.dim() == 4 and v.shape == k.shape and k.shape[0] == b
          and k.shape[3] == d, "k and v must be [B, S, Hkv, D] like q")
    s, hkv = k.shape[1], k.shape[2]
    check(hq % hkv == 0, f"q heads {hq} not a multiple of kv heads {hkv}")
    check(q.dtype == k.dtype == v.dtype, "q, k and v must share a dtype")
    if scale is None:
        scale = d ** -0.5
    if not use_kernel(q, k, v):
        return flash_attention_plain(q, k, v, kv_mask, causal=causal,
                                     scale=scale)
    check(q.dtype in _DTYPE_CODES, f"unsupported dtype {q.dtype}")
    check(d in _HEAD_DIMS, f"head dim {d} not in {_HEAD_DIMS}")
    check(all(x.is_contiguous() for x in (q, k, v)),
          "q, k and v must be contiguous")
    check(all(x.data_ptr() % 16 == 0 for x in (q, k, v)),
          "q, k and v must be 16-byte aligned")
    check(not causal or t == s, "causal attention needs T == S")
    mask = _normalize_mask(kv_mask, b, s, q.device)
    out = torch.empty_like(q)
    lib = build.load("flash_attention")
    fn = lib.hocr_flash_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    build.launch(fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if mask is None else mask.data_ptr(), out.data_ptr(),
                 b, t, s, hq, hkv, d, 1 if mask is None else mask.shape[0],
                 int(causal), float(scale), _DTYPE_CODES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
