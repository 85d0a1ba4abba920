"""Flash attention: GQA online-softmax attention, optionally causal.

Port of ``handwritten_ocr_tpu/ops/flash_attention.py``. CUDA tensors go to
the hand-written kernel ``csrc/flash_attention.cu``; CPU tensors to
:func:`flash_attention_plain`, which does the same arithmetic in PyTorch.

Differentiable as the JAX custom VJP is: under autograd the forward is the
kernel (the plain version on the CPU) and the backward is autograd through
:func:`flash_attention_reference`, recomputed from the saved q, k and v.
"""

from __future__ import annotations

import ctypes

import torch

from handwritten_ocr_tpu_torch.ops import build
from handwritten_ocr_tpu_torch.ops.dispatch import check, use_kernel

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (80, 128)     # vision and text head widths
_KEY_TILE = 128            # the bf16 body's key tile; mask rows are padded to it
_MAX_GRID_Y = 65535        # batch x q-heads a launch takes (work items stay an int)
_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int, ctypes.c_void_p)
             + (ctypes.c_int,) * 8 + (ctypes.c_float, ctypes.c_int,
                                      ctypes.c_void_p))


def check_kernel_shapes(q_shape, kv_shape, dtype: torch.dtype, *,
                        causal: bool) -> None:
    """Raise ValueError unless the kernel takes q ``[B, T, Hq, D]`` and k/v
    ``[B, S, Hkv, D]`` of ``dtype``: the limits of the kernel itself, on
    top of the function's. Needs no card."""
    b, t, hq, d = q_shape
    s = kv_shape[1]
    check(dtype in _DTYPE_CODES, f"unsupported dtype {dtype}")
    check(d in _HEAD_DIMS, f"head dim {d} not in {_HEAD_DIMS}")
    row_bytes = d * torch.empty((), dtype=dtype).element_size()
    check(row_bytes % 16 == 0,
          f"head rows of {row_bytes} bytes: TMA strides need multiples of 16")
    check(b * hq <= _MAX_GRID_Y, f"batch x heads {b * hq} > {_MAX_GRID_Y}")
    check(not causal or t == s, "causal attention needs T == S")


def _normalize_mask(kv_mask: torch.Tensor | None, b: int, s: int,
                    device, pad_to: int = 1) -> torch.Tensor | None:
    """``None`` or a ``[1|B, S']`` uint8 tensor (nonzero = key is valid),
    S' = S rounded up to a multiple of ``pad_to`` with masked keys."""
    if kv_mask is None:
        return None
    mask = kv_mask.to(device=device)
    if mask.dim() == 1:
        mask = mask[None]
    check(mask.dim() == 2 and mask.shape[1] == s
          and mask.shape[0] in (1, b), f"kv_mask must be [S] or [B, S], got "
          f"{tuple(kv_mask.shape)}")
    mask = (mask != 0).to(torch.uint8)
    return torch.nn.functional.pad(mask, (0, -s % pad_to)).contiguous()


def _allowed(kv_mask, b: int, t: int, s: int, causal: bool,
             device) -> torch.Tensor:
    """Bool ``[1|B, 1, 1, T|1, S]``: the keys each query row may attend."""
    mask = _normalize_mask(kv_mask, b, s, device)
    allowed = torch.ones((1, s), dtype=torch.bool, device=device) \
        if mask is None else mask.bool()
    allowed = allowed.reshape(-1, 1, 1, 1, s)
    if causal:
        rows = torch.arange(t, device=device)[:, None]
        cols = torch.arange(s, device=device)[None, :]
        allowed = allowed & (cols <= rows)
    return allowed


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
    allowed = _allowed(kv_mask, b, t, s, causal, q.device)
    scores = scores.masked_fill(~allowed, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(scores - m).masked_fill(~allowed, 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    pv = torch.einsum("bhgts,bshd->bthgd", p.to(v.dtype).float(), v.float())
    out = pv / denom.permute(0, 3, 1, 2, 4)
    return out.reshape(b, t, hq, d).to(q.dtype)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              kv_mask: torch.Tensor | None = None, *,
                              causal: bool = False,
                              scale: float | None = None) -> torch.Tensor:
    """Copy of the JAX package's ``_reference_attention``, the function
    whose gradient the backward takes: as :func:`flash_attention_plain`,
    but P is normalised in fp32 and not rounded to v's dtype. Masked keys
    get no weight and an all-masked row returns 0."""
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    qf = q.float().reshape(b, t, hkv, hq // hkv, d)
    scores = torch.einsum("bthgd,bshd->bhgts", qf, k.float()) * scale
    allowed = _allowed(kv_mask, b, t, s, causal, q.device)
    scores = scores.masked_fill(~allowed, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    safe_m = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(scores - safe_m).masked_fill(~allowed, 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgts,bshd->bthgd", p / denom, v.float())
    return out.reshape(b, t, hq, d).to(q.dtype)


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel (plain version on the CPU). Backward: autograd
    through :func:`flash_attention_reference` from the saved q, k, v and
    mask, as ``_flash_diff_bwd`` in JAX; the mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, scale):
        ctx.save_for_backward(q, k, v, kv_mask)
        ctx.causal, ctx.scale = causal, scale
        return _flash_forward(q, k, v, kv_mask, causal, scale)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, kv_mask = ctx.saved_tensors
        with torch.enable_grad(), \
                torch.profiler.record_function("flash_attention_backward"):
            inputs = [x.detach().requires_grad_() for x in (q, k, v)]
            out = flash_attention_reference(*inputs, kv_mask,
                                            causal=ctx.causal,
                                            scale=ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, inputs, grad)
        return dq, dk, dv, None, None, None


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
    causal prefill (``[8, 1024-1280, 28/4 or 64/8, 128]``) is the same
    shape of problem. So bf16 runs on the tensor cores at their ``wgmma``
    rate, in a persistent kernel (one block per SM walks 128-row q tiles):
    a producer warp streams 128-key K/V tiles by TMA into a 3-stage ring
    of shared memory (mbarriers) and runs ahead into the next q tile; two
    consumer warpgroups each take 64 rows, so one's products run during
    the other's softmax; the scores and P stay in registers and never
    reach device memory, and a key mask is applied as bits. Causal key tiles
    above the diagonal are skipped and causal q tiles come heaviest first
    across all heads. fp32 inputs (the reference runs) run an FMA body
    of the same persistent shape, bound by the FMA pipe and, before it,
    by shared memory's bandwidth: 128-row q tiles whose Q stays in shared
    memory while K and V tiles (128 keys at D = 80, 64 at D = 128) stream
    through a ``cp.async`` ring, each thread an 8 x 8 (8 x 4) block of
    the score tile and 8 rows of O in registers.

    With grad mode on and q, k or v requiring grad it runs as an
    ``autograd.Function`` (forward as above, backward through
    :func:`flash_attention_reference`); otherwise, as in serving, it calls
    the kernel directly.
    """
    b, t, hq, d = q.shape
    check(k.dim() == 4 and v.shape == k.shape and k.shape[0] == b
          and k.shape[3] == d, "k and v must be [B, S, Hkv, D] like q")
    s, hkv = k.shape[1], k.shape[2]
    check(hq % hkv == 0, f"q heads {hq} not a multiple of kv heads {hkv}")
    check(q.dtype == k.dtype == v.dtype, "q, k and v must share a dtype")
    if scale is None:
        scale = d ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, kv_mask, causal, scale)
    return _flash_forward(q, k, v, kv_mask, causal, scale)


def _flash_forward(q, k, v, kv_mask, causal: bool, scale: float):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if not use_kernel(q, k, v):
        return flash_attention_plain(q, k, v, kv_mask, causal=causal,
                                     scale=scale)
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    check_kernel_shapes(q.shape, k.shape, q.dtype, causal=causal)
    check(all(x.is_contiguous() for x in (q, k, v)),
          "q, k and v must be contiguous")
    check(all(x.data_ptr() % 16 == 0 for x in (q, k, v)),
          "q, k and v must be 16-byte aligned")
    mask = _normalize_mask(kv_mask, b, s, q.device, _KEY_TILE)
    out = torch.empty_like(q)
    fn = build.function("flash_attention", "hocr_flash_attention", _ARGTYPES)
    build.launch(fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if mask is None else mask.data_ptr(),
                 0 if mask is None else mask.shape[1], out.data_ptr(),
                 b, t, s, hq, hkv, d, 1 if mask is None else mask.shape[0],
                 int(causal), float(scale), _DTYPE_CODES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
