"""Window attention of the vision tower: block-diagonal attention inside
uniform windows, on packed qkv, with rope applied inside.

Port of ``handwritten_ocr_tpu/ops/window_attention.py``. CUDA tensors go
to the hand-written kernel ``csrc/window_attention.cu``; CPU tensors to
:func:`window_attention_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from handwritten_ocr_tpu_torch.ops import build
from handwritten_ocr_tpu_torch.ops.dispatch import check, use_kernel

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (80,)         # the vision tower's head width
_KERNEL_WINDOW = 64


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


def window_attention(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                     valid: torch.Tensor, *, num_heads: int, window_len: int,
                     scale: float) -> torch.Tensor:
    """qkv ``[B, P, 3·H·hd]``, cos/sin ``[P, hd]``, valid ``[P]`` (dead
    slots 0) → ``[B, P, H·hd]`` in the qkv dtype.

    Replaces the TPU kernels ``handwritten_ocr_tpu/ops/window_attention.py:
    _packed_kernel`` and ``_window_kernel``. On the H100 it is bound by
    bytes at the main-path shape (qkv ``[8, 3456, 3840]`` bf16, 16 heads
    of 80, window 64): it reads 212 MB of qkv and writes 71 MB, against
    ~9 GFLOP. The kernel reads each qkv row once, applies rope on the load,
    keeps the 64 x 64 scores in shared memory and writes only the output;
    one block per (page, window, head) gives 6912 blocks to fill the card.
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
    if not use_kernel(qkv, cos, sin, valid):
        return window_attention_plain(qkv, cos, sin, valid,
                                      num_heads=num_heads,
                                      window_len=window_len, scale=scale)
    check(qkv.dtype in _DTYPE_CODES, f"unsupported dtype {qkv.dtype}")
    check(hd in _HEAD_DIMS, f"head dim {hd} not in {_HEAD_DIMS}")
    check(window_len == _KERNEL_WINDOW,
          f"the kernel takes windows of {_KERNEL_WINDOW}, got {window_len}")
    check(qkv.is_contiguous(), "qkv must be contiguous")
    cos32 = cos.float().contiguous()
    sin32 = sin.float().contiguous()
    valid8 = (valid != 0).to(torch.uint8).contiguous()
    out = torch.empty((b, p_len, d), dtype=qkv.dtype, device=qkv.device)
    fn = build.load("window_attention").hocr_window_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    build.launch(fn, qkv.data_ptr(), cos32.data_ptr(), sin32.data_ptr(),
                 valid8.data_ptr(), out.data_ptr(), b, p_len, num_heads, hd,
                 window_len, float(scale), _DTYPE_CODES[qkv.dtype],
                 torch.cuda.current_stream(qkv.device).cuda_stream)
    window_attention.launches += 1
    return out


window_attention.launches = 0
