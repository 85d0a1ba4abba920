"""Weight-only int8 matrix product: dequantise on the chip, not in memory.

Port of ``handwritten_ocr_tpu/ops/int8_matmul.py``. CUDA tensors go to the
hand-written kernel ``csrc/int8_matmul.cu``; CPU tensors to
:func:`int8_matmul_plain`.

Layout (the port's ``[out, in]``): x ``[M, IN]``, w_q ``[OUT, IN]`` int8,
scale ``[OUT]`` float32 per output channel → out ``[M, OUT]``.
"""

from __future__ import annotations

import ctypes

import torch

from handwritten_ocr_tpu_torch.ops import build
from handwritten_ocr_tpu_torch.ops.dispatch import check, use_kernel

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_ROWS = 32              # decode-shaped calls: the kernel's row limit
_KC = 64                   # k per chunk of the kernel
_BLOCK_CHANNELS = 64       # output channels per block of the kernel
# Blocks to aim for when K is split (132 SMs x 4 blocks): enough 16-byte
# loads in flight to keep the card's memory busy.
_TARGET_BLOCKS = 528


def int8_matmul_supported(d_in: int, d_out: int) -> bool:
    """Whether a product goes to the kernel (the JAX package's rule)."""
    return d_in >= 128 and d_out >= 128


def int8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                      out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the int8 weight widened,
    products summed in fp32, the per-channel scale applied to the fp32
    sum, then one cast to ``out_dtype`` (default: x's dtype)."""
    acc = x.float() @ w_q.float().t()
    return (acc * scale.float()).to(out_dtype or x.dtype)


def _split(m: int, n: int, k: int, dtype: torch.dtype) -> tuple[int, int]:
    """(splits of K over blocks, 64-wide k chunks per split)."""
    chunks = -(-k // _KC)
    if dtype != torch.bfloat16:
        return 1, chunks
    blocks = -(-n // _BLOCK_CHANNELS)
    split = max(1, min(chunks // 2, -(-_TARGET_BLOCKS // blocks)))
    per_split = -(-chunks // split)
    return -(-chunks // per_split), per_split


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor, *,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``(x @ dequant(w_q)^T)`` with per-output-channel scales.

    ``out_dtype`` defaults to x's dtype; the lm_head passes
    ``torch.float32`` so that the greedy argmax sees the fp32 sum (the
    scale is applied to the fp32 sum either way).

    Replaces the TPU kernel ``handwritten_ocr_tpu/ops/int8_matmul.py:
    _kernel``. On the H100 it is bound by bytes: at a decode step (M ≤ 24
    live rows) it does 2·M flops per weight byte against the card's ~295
    flops per byte of bf16, so its time is the weight read, 1 byte per
    weight (qwen3:32b: 131 MB for the gate, 0.039 ms at 3.35 TB/s; 778 MB
    for the lm_head, 0.232 ms). The JAX package sends only the lm_head to
    its Pallas kernel by default and leaves the projections to XLA, which
    fuses the int8 widening into the product's read; PyTorch has no such
    fused operation (``x @ w_q.to(bf16)`` reads 1 byte per weight, writes
    2 and reads 2), so in the port every decode-shaped int8 product
    launches this kernel. The kernel widens in registers and runs the
    product on the tensor cores (``mma.sync`` bf16 → fp32), one warp per
    16 output channels, with K split over blocks where the channels alone
    give too few blocks to fill the card.
    """
    check(x.dim() == 2 and w_q.dim() == 2 and x.shape[1] == w_q.shape[1],
          "x must be [M, IN] and w_q [OUT, IN]")
    check(w_q.dtype == torch.int8, "w_q must be int8")
    check(scale.shape == (w_q.shape[0],) and scale.dtype == torch.float32,
          "scale must be float32 [OUT]")
    out_dtype = out_dtype or x.dtype
    if not use_kernel(x, w_q, scale):
        return int8_matmul_plain(x, w_q, scale, out_dtype)
    m, k = x.shape
    n = w_q.shape[0]
    check(m <= MAX_ROWS, f"the kernel takes at most {MAX_ROWS} rows, got {m}")
    check(x.dtype in _DTYPE_CODES and out_dtype in _DTYPE_CODES,
          f"unsupported dtypes {x.dtype} -> {out_dtype}")
    check(x.dtype == torch.bfloat16 or out_dtype == torch.float32,
          "fp32 x needs fp32 output")
    check(all(t.is_contiguous() for t in (x, w_q, scale)),
          "x, w_q and scale must be contiguous")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    split, per_split = _split(m, n, k, x.dtype)
    partial = (torch.empty(split * m * n, dtype=torch.float32, device=x.device)
               if split > 1 else None)
    aligned = (k % 16 == 0 and x.data_ptr() % 16 == 0
               and w_q.data_ptr() % 16 == 0)
    fn = build.load("int8_matmul").hocr_int8_matmul
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    build.launch(fn, x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                 out.data_ptr(), None if partial is None else partial.data_ptr(),
                 m, n, k, split, per_split, int(aligned),
                 _DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
