"""Window attention of the vision tower: block-diagonal attention inside
uniform windows, on packed qkv, with rope applied inside.

Port of ``handwritten_ocr_tpu/ops/window_attention.py``. CUDA tensors go
to the hand-written kernel ``csrc/window_attention.cu``; CPU tensors to
:func:`window_attention_plain`.

Differentiable as the JAX custom VJP is: under autograd the forward is the
kernel (the plain version on the CPU) and the backward is autograd through
:func:`window_attention_reference`; the gradient flows to qkv only.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from handwritten_ocr_tpu_torch.ops import build
from handwritten_ocr_tpu_torch.ops.dispatch import check, use_kernel

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (80,)         # the vision tower's head width
_KERNEL_WINDOW = 64
_HEAD_GROUP = 2            # heads per block of the bf16 body
_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5
             + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))


@functools.lru_cache(maxsize=None)
def check_kernel_shapes(qkv_shape, dtype: torch.dtype, *, num_heads: int,
                        window_len: int) -> None:
    """Raise ValueError unless the kernel takes packed qkv ``[B, P, 3·H·hd]``
    of ``dtype`` in windows of ``window_len``: the limits of the kernel
    itself, on top of the function's. Needs no card; a shape that passed
    is not checked again."""
    hd = qkv_shape[2] // 3 // num_heads
    check(dtype in _DTYPE_CODES, f"unsupported dtype {dtype}")
    check(hd in _HEAD_DIMS, f"head dim {hd} not in {_HEAD_DIMS}")
    check(window_len == _KERNEL_WINDOW,
          f"the kernel takes windows of {_KERNEL_WINDOW}, got {window_len}")
    check(num_heads % _HEAD_GROUP == 0,
          f"{num_heads} heads do not split into groups of {_HEAD_GROUP}")
    row_bytes = hd * dtype.itemsize
    check(row_bytes % 16 == 0,
          f"head rows of {row_bytes} bytes do not split into 16-byte vectors")


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x * cos + rotate_half(x) * sin in fp32, rounded once to x's dtype."""
    half = x.shape[-1] // 2
    xf = x.float()
    rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + rot * sin).to(x.dtype)


def window_attention_plain(qkv: torch.Tensor, cos: torch.Tensor,
                           sin: torch.Tensor, valid: torch.Tensor, *,
                           num_heads: int, window_len: int,
                           scale: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch: rope tables rounded to the
    qkv dtype, roped q/k rounded to it, fp32 scores with dead keys at
    -inf, guarded softmax (an all-dead window row returns 0), P normalised
    and rounded to the qkv dtype before the P.V product."""
    b, p_len, three_d = qkv.shape
    d = three_d // 3
    hd = d // num_heads
    n_win = p_len // window_len
    dtype = qkv.dtype
    q, k, v = qkv.split(d, dim=-1)
    cos_b = cos.to(dtype).float()[None, :, None, :]
    sin_b = sin.to(dtype).float()[None, :, None, :]

    def windows(x):
        return x.reshape(b, n_win, window_len, num_heads, hd)

    qw = windows(_rope(q.reshape(b, p_len, num_heads, hd), cos_b, sin_b))
    kw = windows(_rope(k.reshape(b, p_len, num_heads, hd), cos_b, sin_b))
    vw = windows(v.reshape(b, p_len, num_heads, hd))
    scores = torch.einsum("bwthd,bwshd->bwhts", qw.float(), kw.float()) * scale
    key_ok = (valid != 0).reshape(1, n_win, 1, 1, window_len)
    scores = scores.masked_fill(~key_ok, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(scores - m).masked_fill(~key_ok, 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    weights = (p / denom).to(dtype).float()
    out = torch.einsum("bwhts,bwshd->bwthd", weights, vw.float())
    return out.reshape(b, p_len, d).to(dtype)


def window_attention_reference(qkv: torch.Tensor, cos: torch.Tensor,
                               sin: torch.Tensor, valid: torch.Tensor, *,
                               num_heads: int, window_len: int,
                               scale: float) -> torch.Tensor:
    """Copy of the JAX package's ``_window_reference``, the function whose
    gradient the backward takes: rope in the qkv dtype (the plain version
    ropes in fp32 and rounds once), fp32 scores with dead keys at -inf,
    guarded softmax, P normalised and rounded to the qkv dtype, fp32 P.V."""
    b, p_len, three_d = qkv.shape
    d = three_d // 3
    hd = d // num_heads
    n_win = p_len // window_len
    dtype = qkv.dtype
    q, k, v = qkv.split(d, dim=-1)
    cos_b = cos.to(dtype)[None, :, None, :]
    sin_b = sin.to(dtype)[None, :, None, :]

    def rope(x):
        x = x.reshape(b, p_len, num_heads, hd)
        rot = torch.cat([-x[..., hd // 2:], x[..., :hd // 2]], dim=-1)
        return x * cos_b + rot * sin_b

    def windows(x):
        return x.reshape(b, n_win, window_len, num_heads, hd)

    qw, kw = windows(rope(q)), windows(rope(k))
    vw = windows(v)
    scores = torch.einsum("bwthd,bwshd->bwhts", qw.float(), kw.float()) * scale
    key_ok = (valid != 0).reshape(1, n_win, 1, 1, window_len)
    scores = scores.masked_fill(~key_ok, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(scores - m).masked_fill(~key_ok, 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bwhts,bwshd->bwthd", (p / denom).to(dtype).float(),
                       vw.float())
    return out.reshape(b, p_len, d).to(dtype)


class _WindowAttention(torch.autograd.Function):
    """Forward: the kernel (plain version on the CPU). Backward: autograd
    through :func:`window_attention_reference` from the saved qkv, as
    ``_window_diff_bwd`` in JAX; cos, sin and valid get no gradient."""

    @staticmethod
    def forward(ctx, qkv, cos, sin, valid, num_heads, window_len, scale):
        ctx.save_for_backward(qkv, cos, sin, valid)
        ctx.args = dict(num_heads=num_heads, window_len=window_len,
                        scale=scale)
        return _window_forward(qkv, cos, sin, valid, **ctx.args)

    @staticmethod
    def backward(ctx, grad):
        qkv, cos, sin, valid = ctx.saved_tensors
        with torch.enable_grad(), \
                torch.profiler.record_function("window_attention_backward"):
            x = qkv.detach().requires_grad_()
            out = window_attention_reference(x, cos, sin, valid, **ctx.args)
            (dqkv,) = torch.autograd.grad(out, (x,), grad)
        return dqkv, None, None, None, None, None, None


def window_attention(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                     valid: torch.Tensor, *, num_heads: int, window_len: int,
                     scale: float) -> torch.Tensor:
    """qkv ``[B, P, 3·H·hd]``, cos/sin ``[P, hd]``, valid ``[P]`` (dead
    slots 0) → ``[B, P, H·hd]`` in the qkv dtype.

    Replaces the TPU kernels ``handwritten_ocr_tpu/ops/window_attention.py:
    _packed_kernel`` and ``_window_kernel``. On the H100 it is bound by
    bytes at the main-path shape (qkv ``[8, 3456, 3840]`` bf16, 16 heads
    of 80, window 64): it reads 212 MB of qkv and writes 71 MB, against
    ~9 GFLOP. The kernel moves each byte once in 16-byte vectors: one
    block per (page, window, pair of heads) loads the pair's rows by
    ``cp.async``, reads the window's rope tables once for both heads,
    ropes q and k in registers, runs both products on the tensor cores
    (``mma.sync`` bf16 → fp32) with the scores in registers, and writes
    whole head rows.

    fp32 qkv (the reference tower, fp32 reads) takes the fp32 body: one
    block per (page, window, head), four on an SM (q, then k and v in
    one tile: 43 KB), both products on the tensor cores in 3xTF32 (each
    operand split into two tf32 parts, three ``mma.sync`` products
    summed in fp32), the scores and P in registers. It errs ~1e-6 of the
    output, inside the fp32 bound that a single TF32 pass fails.

    With grad mode on and qkv requiring grad it runs as an
    ``autograd.Function`` (forward as above, backward through
    :func:`window_attention_reference`); otherwise, as in serving, it
    calls the kernel directly.
    """
    b, p_len, three_d = qkv.shape
    d = three_d // 3
    check(three_d == 3 * d and d % num_heads == 0,
          f"qkv width {three_d} is not 3 x {num_heads} heads")
    hd = d // num_heads
    check(p_len % window_len == 0, "P must be a whole number of windows")
    check(cos.shape == (p_len, hd) and sin.shape == (p_len, hd),
          f"cos/sin must be [{p_len}, {hd}]")
    check(valid.shape == (p_len,), f"valid must be [{p_len}]")
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _WindowAttention.apply(qkv, cos, sin, valid, num_heads,
                                      window_len, scale)
    return _window_forward(qkv, cos, sin, valid, num_heads=num_heads,
                           window_len=window_len, scale=scale)


def _window_forward(qkv, cos, sin, valid, *, num_heads: int,
                    window_len: int, scale: float) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if not use_kernel(qkv, cos, sin, valid):
        return window_attention_plain(qkv, cos, sin, valid,
                                      num_heads=num_heads,
                                      window_len=window_len, scale=scale)
    b, p_len, three_d = qkv.shape
    d = three_d // 3
    hd = d // num_heads
    check_kernel_shapes(qkv.shape, qkv.dtype, num_heads=num_heads,
                        window_len=window_len)
    check(qkv.is_contiguous(), "qkv must be contiguous")
    cos32 = cos.float().contiguous()
    sin32 = sin.float().contiguous()
    check(all(x.data_ptr() % 16 == 0 for x in (qkv, cos32, sin32)),
          "qkv and cos/sin must be 16-byte aligned")
    # The kernel reads one byte a slot (0 = dead) and copies a window's
    # 64 bytes at once: a bool or uint8 mask is read as it is.
    valid8 = valid.view(torch.uint8) if (
        valid.dtype in (torch.bool, torch.uint8) and valid.is_contiguous()
        and valid.data_ptr() % 16 == 0) else (valid != 0).to(torch.uint8)
    out = torch.empty((b, p_len, d), dtype=qkv.dtype, device=qkv.device)
    fn = build.function("window_attention", "hocr_window_attention",
                        _ARGTYPES)
    build.launch(fn, qkv.data_ptr(), cos32.data_ptr(), sin32.data_ptr(),
                 valid8.data_ptr(), out.data_ptr(), b, p_len, num_heads, hd,
                 window_len, float(scale), _DTYPE_CODES[qkv.dtype],
                 torch.cuda.current_stream(qkv.device).cuda_stream)
    window_attention.launches += 1
    return out


window_attention.launches = 0
