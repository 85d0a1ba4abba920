"""Weight-only int8 matrix product: dequantise on the chip, not in memory.

Port of ``handwritten_ocr_tpu/ops/int8_matmul.py``. CUDA tensors go to the
hand-written kernel ``csrc/int8_matmul.cu``; CPU tensors to
:func:`int8_matmul_plain`.

Layout (the port's ``[out, in]``): x ``[M, IN]``, w_q ``[OUT, IN]`` int8,
scale ``[OUT]`` float32 per output channel → out ``[M, OUT]``.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import NamedTuple

import torch

from handwritten_ocr_tpu_torch.ops import build
from handwritten_ocr_tpu_torch.ops.dispatch import check, use_kernel

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_ROWS = 32              # decode-shaped calls: the kernel's row limit
_K_PIECE = 64              # K splits in multiples of this
# The split-K merge: the last block of a channel block reads every split's
# fp32 partial; keep that within this many bytes where the card allows.
_MERGE_BYTES = 128 * 1024
# The fp32-x body: 128 output channels a block, and no split of K shorter
# than this (a block's prologue and merge would outweigh its products).
_F32_BLOCK = 128
_F32_MIN_SPLIT_K = 1024
# The kernel's arguments as one record (``Int8MatmulCall`` in the source):
# 7 pointers (0 for none), then 9 ints.
_CALL = struct.Struct("=7Q9i")
_WORKSPACE = build.Workspace()


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


class Plan(NamedTuple):
    """One launch of the kernel: blocks of ``block_channels`` output
    channels, K split into ``split`` ranges of ``k_per_split``, the grid,
    and the workspace it takes (fp32 partials and int32 counters, 0
    without a split)."""
    block_channels: int
    split: int
    k_per_split: int
    grid: tuple[int, int]
    partial: int
    counters: int


@functools.lru_cache(maxsize=None)
def plan(m: int, n: int, k: int, sms: int, bf16: bool = True) -> Plan:
    """The launch for x ``[m, k]`` and w ``[n, k]`` on a card of ``sms``
    SMs. Where blocks of 128 channels give every SM one, K is not split.
    Else the plan takes the block width (64 or 128 channels) and the split
    of K (64-wide pieces, none empty) that give every SM one or two blocks
    and, of those, stream the fewest weight bytes through the busiest SM
    (an SM streams its blocks at a rate of its own, measured on the H100:
    two blocks on one SM take about twice as long as one), then the fewest
    blocks, then the least for the split merge to read, within
    ``_MERGE_BYTES`` per channel block where possible. fp32 x (an FMA
    body, bound by operations) takes blocks of 128 channels and the split
    of K, in pieces of at least ``_F32_MIN_SPLIT_K``, whose busiest SM does
    the fewest products (blocks spread evenly over the SMs), then the
    fewest splits. Needs no card."""
    if not bf16:
        return _plan_fp32(m, n, k, sms)
    if -(-n // 128) >= sms:
        return Plan(128, 1, k, (-(-n // 128), 1), 0, 0)
    pieces = -(-k // _K_PIECE)
    options = []
    for bn in (128, 64):
        blocks = -(-n // bn)
        for want in range(1, pieces + 1):
            per_split = -(-pieces // want)
            split = -(-pieces // per_split)
            k_per_split = min(k, per_split * _K_PIECE)
            busiest = -(-blocks * split // sms) * bn * k_per_split
            merge = split * m * bn * 4
            one_wave = sms <= blocks * split <= 2 * sms
            options.append((not one_wave, merge > _MERGE_BYTES,
                            busiest, blocks * split, merge, bn, split,
                            k_per_split))
    *_, bn, split, k_per_split = min(options)
    blocks = -(-n // bn)
    if split == 1:
        return Plan(bn, 1, k, (blocks, 1), 0, 0)
    return Plan(bn, split, k_per_split, (blocks, split),
                blocks * split * m * bn, blocks)


def _plan_fp32(m: int, n: int, k: int, sms: int) -> Plan:
    """The fp32-x body's launch (see :func:`plan`)."""
    blocks = -(-n // _F32_BLOCK)
    pieces = -(-k // _K_PIECE)
    options = []
    for want in range(1, pieces + 1):
        per_split = -(-pieces // want)
        split = -(-pieces // per_split)
        k_per_split = min(k, per_split * _K_PIECE)
        if split > 1 and k_per_split < _F32_MIN_SPLIT_K:
            break
        busiest = -(-blocks * split // sms) * k_per_split
        options.append((busiest, split, k_per_split))
    _, split, k_per_split = min(options)
    if split == 1:
        return Plan(_F32_BLOCK, 1, k, (blocks, 1), 0, 0)
    return Plan(_F32_BLOCK, split, k_per_split, (blocks, split),
                blocks * split * m * _F32_BLOCK, blocks)


_CHECKED = set()   # argument signatures whose shapes and dtypes passed


def _check_args(x, w_q, scale, out_dtype, *, kernel: bool) -> None:
    """Raise ValueError unless the arguments' shapes and dtypes are valid
    (``kernel``: also within the kernel's own limits). They depend on
    nothing else, so the wrapper runs them once per signature."""
    check(x.dim() == 2 and w_q.dim() == 2 and x.shape[1] == w_q.shape[1],
          "x must be [M, IN] and w_q [OUT, IN]")
    check(w_q.dtype == torch.int8, "w_q must be int8")
    check(scale.shape == (w_q.shape[0],) and scale.dtype == torch.float32,
          "scale must be float32 [OUT]")
    if kernel:
        check(x.shape[0] <= MAX_ROWS,
              f"the kernel takes at most {MAX_ROWS} rows, got {x.shape[0]}")
        check(x.dtype in _DTYPE_CODES and out_dtype in _DTYPE_CODES,
              f"unsupported dtypes {x.dtype} -> {out_dtype}")
        check(x.dtype == torch.bfloat16 or out_dtype == torch.float32,
              "fp32 x needs fp32 output")


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
    launches this kernel. A block of 8 warps owns 128 output channels (4
    warps and 64 where :func:`plan` finds that balances the SMs better) and
    streams its 128-wide k tiles of int8 weights and the matching slice of x
    through a 4-stage ring of shared memory (``cp.async``), so x is read
    once per block and three tiles' loads fly while one computes; the
    warps widen the weights in registers and run the product on the
    tensor cores (``mma.sync`` bf16 → fp32). Where the channels alone give
    too few blocks to fill the card, K is split over blocks in the same
    launch: the last block of each channel tile sums the fp32 partials in
    split order (a self-resetting arrival counter in a per-device
    workspace), so two calls give bit-equal results. fp32 x (the fp32
    reference runs) takes an FMA body, bound by operations: blocks of 128
    channels stream W and fp32 x through the same kind of ring, each lane
    widens 16 weights of each of its 4 channels exactly and does 16 fp32
    FMAs per read of x from shared memory, and K splits over blocks with
    the same merge (no TF32: the products stay in full fp32).
    """
    out_dtype = out_dtype or x.dtype
    kernel = use_kernel(x, w_q, scale)
    signature = (kernel, x.shape, x.dtype, w_q.shape, w_q.dtype, scale.shape,
                 scale.dtype, out_dtype)
    if signature not in _CHECKED:
        _check_args(x, w_q, scale, out_dtype, kernel=kernel)
        _CHECKED.add(signature)
    if not kernel:
        return int8_matmul_plain(x, w_q, scale, out_dtype)
    check(x.is_contiguous() and w_q.is_contiguous() and scale.is_contiguous(),
          "x, w_q and scale must be contiguous")
    m, k = x.shape
    n = w_q.shape[0]
    device = x.device
    out = torch.empty((m, n), dtype=out_dtype, device=device)
    launch = plan(m, n, k, build.sm_count(device.index),
                  x.dtype == torch.bfloat16)
    partial = counters = 0
    if launch.split > 1:
        partial = _WORKSPACE.take(device, torch.float32,
                                  launch.partial).data_ptr()
        counters = _WORKSPACE.take(device, torch.int32,
                                   launch.counters).data_ptr()
    x_ptr, w_ptr = x.data_ptr(), w_q.data_ptr()
    aligned = k % 16 == 0 and x_ptr % 16 == 0 and w_ptr % 16 == 0
    build.launch(build.function("int8_matmul", "hocr_int8_matmul",
                                (ctypes.c_char_p,)),
                 _CALL.pack(x_ptr, w_ptr, scale.data_ptr(), out.data_ptr(),
                            partial, counters, build.current_stream(device),
                            m, n, k, launch.split, launch.k_per_split,
                            launch.block_channels, aligned,
                            _DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype]))
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
