"""Fused append + paged GQA attention: the decode step's attention.

Port of ``handwritten_ocr_tpu/ops/paged_decode_attention.py``, both
branches: a full-precision KV cache, and the int8 KV cache (int8 pools
with per-token, per-head fp32 scale pools). CUDA tensors go to the
hand-written kernel ``csrc/paged_decode_attention.cu``; CPU tensors to
:func:`paged_append_attention_plain`. Both update the pools IN PLACE,
where the JAX kernel returns them aliased.
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
_HEAD_DIMS = (128,)        # the text models' head width
_ROW_TILE = 16             # query rows per tile of every body
_KEY_TILE = 64             # context cols per tile of every body
# Every body is one persistent launch over the live work
# (``csrc/paged_decode_attention.cu``: ``paged_mma_kernel`` for bf16 q,
# ``paged_f32_kernel`` for fp32 q). Their K/V ring of shared memory: 3
# stages of a 64-col tile, int8 K and V with their fp32 scales, bf16 K and
# V, or fp32 K and V; over int8 pools also the new rows quantised (T rows
# of K and V, two scales each) and the widened tile: bf16 at T > 1 (at T =
# 1 the int8 tensor-core body widens in registers), fp32 for fp32 q; then
# the work list, 5 ints a slot and one.
_STAGES = 3
_STAGE_BYTES = {"int8": 2 * _KEY_TILE * 128 + 2 * _KEY_TILE * 4,
                "bf16": 2 * _KEY_TILE * 128 * 2,
                "fp32": 2 * _KEY_TILE * 128 * 4}
_WIDE_BYTES = 2 * _KEY_TILE * 128 * 2
_F32_WARPS = 8             # the fp32 body's block
_MERGE_ROW_BYTES = (128 + 2) * 4   # a partial row: O, m and l in fp32
_SMEM_PER_SM = 228 * 1024  # H100: shared memory of an SM (227 KB a block)
_SMEM_PER_BLOCK = 227 * 1024
_STATIC_SMEM = 64          # a block's static shared memory (an mbarrier, a flag)
_BLOCK_RESERVE = 1024 + _STATIC_SMEM   # and the system's 1 KB a block
_MAX_WARPS = 12            # row tiles a block serves in one pass (T > 1)
_FULL_WARPS = 8            # up to 8 warps: 255 registers a thread, q in them
_MIN_CHUNK_TILES = 2       # the shortest chunk: two ring tiles in flight
# New tokens per call the int8 kernel quantises in shared memory
# (decode-shaped calls have T <= 64).
_MAX_NEW_INT8 = 64
# The kernel's arguments as one record (``PagedCall`` in the source): 15
# pointers (0 for none), 15 ints, the float scale, the dtype code.
_CALL = struct.Struct("=15Q15ifi")
_WORKSPACE = build.Workspace()


class Plan(NamedTuple):
    """One launch of the kernel: ``row_tiles`` tiles of 16 of the G*T
    query rows of a kv-head, a 1-D grid of ``grid[0]`` blocks of
    ``threads`` threads and ``smem`` bytes of dynamic shared memory, the
    workspace it takes (``partials`` rows of fp32 partials, D + 2 floats
    each, and int32 ``counters``), chunks of at least ``min_chunk_tiles``
    64-col tiles, at most ``max_chunks`` of them a (slot, kv-head) (whose
    partials the merge brings into :func:`merge_bytes` of shared memory
    two rows at a time) and at most ``max_items`` work items. The
    tensor-core bodies: ``col_groups`` warps on each row tile (4 at T =
    1, where the four warps split each tile's cols; 1 else); the fp32
    body chooses its own per pass (0 here)."""
    row_tiles: int
    grid: tuple
    threads: int
    partials: int
    counters: int
    smem: int = 0
    col_groups: int = 0
    min_chunk_tiles: int = 0
    max_items: int = 0
    max_chunks: int = 0


def body(q_dtype: torch.dtype, quant: bool) -> str:
    """The kernel body a call runs: ``"bf16"`` (bf16 q over bf16 pools,
    tensor cores), ``"int8"`` (bf16 q over int8 pools, tensor cores) or
    ``"fp32"`` (fp32 q over either, FMAs)."""
    if q_dtype == torch.float32:
        return "fp32"
    return "int8" if quant else "bf16"


def mma_smem(kind: str, t: int, col_groups: int, q_warps: int,
             slots: int) -> int:
    """Dynamic shared memory of a tensor-core launch of body ``kind`` at
    ``t`` new tokens and ``col_groups`` warps a row tile, whose ``q_warps``
    warps keep their q tiles in shared memory (blocks of more than 8
    warps), over ``slots`` slots (``mma_smem_bytes``, ``work_list_offset``
    and ``work_list_bytes`` in the source)."""
    smem = _STAGES * _STAGE_BYTES[kind] + q_warps * _ROW_TILE * 128 * 2
    if kind == "int8":
        smem += (_WIDE_BYTES if col_groups == 1 else 0) + t * (2 * 128 + 2 * 4)
    return -(-smem // 16) * 16 + 4 * (5 * slots + 1)


def f32_smem(slots: int) -> int:
    """Dynamic shared memory of an fp32 launch over fp32 pools, the larger
    of its two (``f32_smem_bytes``, ``work_list_offset`` and
    ``work_list_bytes`` in the source): the ring of fp32 tiles, then the
    work list. Over int8 pools (T <= 64) the ring of int8 tiles, the
    widened fp32 tile and the new rows take less."""
    return _STAGES * _STAGE_BYTES["fp32"] + 4 * (5 * slots + 1)


def merge_bytes(kind: str, col_groups: int) -> int:
    """Shared memory the chunk merge may fill: the ring and, over int8
    pools at ``col_groups`` 1, the widened tile (``merge_bytes`` in the
    source). ``"fp32"``: the smaller of the fp32 body's two buffers, the
    int8 ring and the widened fp32 tile (``f32_merge_bytes(true)``)."""
    if kind == "fp32":
        return _STAGES * _STAGE_BYTES["int8"] + _STAGE_BYTES["fp32"]
    wide = _WIDE_BYTES if kind == "int8" and col_groups == 1 else 0
    return _STAGES * _STAGE_BYTES[kind] + wide


def blocks_per_sm(kind: str, t: int, col_groups: int, slots: int) -> int:
    """Blocks of a tensor-core launch that share an SM: at T = 1, where a
    block is 4 warps of up to 255 registers a thread, two where the shared
    memory allows (more blocks would shorten the chunks, whose merges cost
    more than the blocks gain); one block of 8 to 12 warps (255 registers
    a thread up to 8 warps, 168 above) else."""
    if col_groups == 1:
        return 1
    return max(1, min(2, _SMEM_PER_SM // (mma_smem(kind, t, col_groups, 0,
                                                   slots)
                                          + _BLOCK_RESERVE)))


@functools.lru_cache(maxsize=None)
def plan(slots: int, t: int, hq: int, hkv: int, width_cols: int,
         kind: str, sms: int) -> Plan:
    """The launch of body ``kind`` (:func:`body`) for q ``[slots, t, hq,
    128]`` over tables of ``width_cols`` = W*BS cols on a card of ``sms``
    SMs. Needs no card.

    Every body launches one wave: ``sms`` x :func:`blocks_per_sm` blocks
    (the fp32 body: one block of 8 warps an SM), fewer where the table
    cannot give that many items; the kernel itself chunks the live cols
    (``build_work_list`` in the source), so the host needs to know
    neither which slots are live nor how long their contexts are. A live
    slot has ceil((start + n_valid) / 64) tiles; the chunk length L is
    the shortest, at least ``min_chunk_tiles`` and ceil(most tiles /
    ``max_chunks``), at which
    Hkv x sum ceil(tiles / L) items fit the grid (else one chunk a pair);
    a slot's pairs then take ceil(tiles / L) chunks of ceil(tiles /
    chunks) tiles, the last what is left. Its workspace holds the
    partials of ``max_items`` = blocks + slots x Hkv items (the chunk rule
    never makes more), G*T rows each (padded to an even count), and a
    counter per (slot, kv-head). Raises ValueError where the slots' work
    list does not fit a block's shared memory."""
    rows = (hq // hkv) * t
    row_tiles = -(-rows // _ROW_TILE)
    if kind == "fp32":
        col_groups, warps, per_sm = 0, _F32_WARPS, 1
        smem = f32_smem(slots)
    else:
        col_groups = 4 if row_tiles == 1 else 1
        warps = 4 if col_groups == 4 else min(_MAX_WARPS, max(8, row_tiles))
        per_sm = blocks_per_sm(kind, t, col_groups, slots)
        smem = mma_smem(kind, t, col_groups,
                        warps if warps > _FULL_WARPS else 0, slots)
    tiles = -(-width_cols // _KEY_TILE)
    most_items = slots * hkv * -(-tiles // _MIN_CHUNK_TILES)
    blocks = max(1, min(sms * per_sm, most_items))
    max_items = blocks + slots * hkv
    if smem > _SMEM_PER_BLOCK - _STATIC_SMEM:
        raise ValueError(f"the work list of {slots} slots does not fit a "
                         f"block's shared memory ({smem} bytes)")
    return Plan(row_tiles, (blocks,), 32 * warps, max_items * (rows + rows % 2),
                slots * hkv, smem=smem, col_groups=col_groups,
                min_chunk_tiles=_MIN_CHUNK_TILES, max_items=max_items,
                max_chunks=merge_bytes(kind, col_groups)
                // (2 * _MERGE_ROW_BYTES))


def _int32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a contiguous int32 tensor, without a copy when it is one."""
    if x.dtype == torch.int32 and x.is_contiguous():
        return x
    return x.to(torch.int32).contiguous()


def quantize_rows(new: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token, per-head int8 quantisation of ``[..., D]`` rows:
    scale = max(amax over D, 1e-6) / 127 in fp32, q = round-half-even(
    row / scale) with no clip (|q| <= 127 by construction). Bit-equal to
    the JAX package's ``models/paged.py:_quantize_rows`` and to the
    kernel's in-kernel append."""
    f = new.float()
    # A tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the rounded quotient.
    scales = torch.clamp_min(f.abs().amax(dim=-1), 1e-6) / f.new_full((), 127.0)
    q = torch.round(f / scales[..., None]).to(torch.int8)
    return q, scales


def _append_plain(k_new, v_new, k_pool, v_pool, tables, start, n_valid,
                  layer: int, k_scale_pool=None, v_scale_pool=None) -> None:
    """Write token i < n_valid[s] of each slot at min(start + i, cap);
    with scale pools, the int8 rows of :func:`quantize_rows` and their
    scales (scale pools ``[L, N, Hkv, BS]``)."""
    s, t = k_new.shape[:2]
    bs = k_pool.shape[2]
    cap = tables.shape[1] * bs - 1
    tok = torch.arange(t, device=k_new.device)
    valid = tok[None, :] < n_valid[:, None]
    pos = torch.clamp(start[:, None].long() + tok[None, :], max=cap)
    blocks = torch.take_along_dim(tables.long(), pos // bs, dim=1)
    rows, toks = valid.nonzero(as_tuple=True)
    blk, off = blocks[rows, toks], (pos % bs)[rows, toks]
    k_rows, v_rows = k_new[rows, toks], v_new[rows, toks]
    if k_scale_pool is not None:
        k_rows, k_scales = quantize_rows(k_rows)
        v_rows, v_scales = quantize_rows(v_rows)
        k_scale_pool[layer, blk, :, off] = k_scales
        v_scale_pool[layer, blk, :, off] = v_scales
    k_pool[layer, blk, off] = k_rows.to(k_pool.dtype)
    v_pool[layer, blk, off] = v_rows.to(v_pool.dtype)


def paged_append_attention_plain(q, k_new, v_new, k_pool, v_pool, tables,
                                 start, n_valid, k_scale_pool=None,
                                 v_scale_pool=None, *, layer: int,
                                 scale: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch: append, gather the slot's
    pages, fp32 attention where query token i sees cols <= start + i;
    rows i >= n_valid (and every row of an n_valid == 0 slot) are 0.

    int8 pools dequantise in score space, as the TPU kernel does: scores
    of the int8 keys times k_scale[col]; the denominator sums the
    probabilities, which are then multiplied by v_scale[col] before the
    product with the int8 values."""
    s, t, hq, d = q.shape
    hkv = k_new.shape[2]
    group = hq // hkv
    quant = k_scale_pool is not None
    _append_plain(k_new, v_new, k_pool, v_pool, tables, start, n_valid, layer,
                  k_scale_pool, v_scale_pool)
    width = tables.shape[1] * k_pool.shape[2]
    idx = tables.long()
    keys = k_pool[layer][idx].reshape(s, width, hkv, d).float()
    values = v_pool[layer][idx].reshape(s, width, hkv, d).float()
    qf = (q.float() * scale).reshape(s, t, hkv, group, d)
    scores = torch.einsum("sthgd,schd->shgtc", qf, keys)
    if quant:   # [L, N, Hkv, BS] -> per slot [Hkv, W * BS]
        def col_scales(pool):
            return (pool[layer][idx].permute(0, 2, 1, 3)
                    .reshape(s, hkv, 1, 1, width))
        scores = scores * col_scales(k_scale_pool)
    tok = torch.arange(t, device=q.device)
    row_valid = tok[None, :] < n_valid[:, None]                   # [S, T]
    cols = torch.arange(width, device=q.device)
    allowed = ((cols[None, None, :]
                <= start[:, None, None].long() + tok[None, :, None])
               & row_valid[:, :, None])                           # [S, T, C]
    allowed = allowed[:, None, None]                              # [S,1,1,T,C]
    scores = scores.masked_fill(~allowed, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(scores - m).masked_fill(~allowed, 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if quant:
        acc = torch.einsum("shgtc,schd->shgtd", p * col_scales(v_scale_pool),
                           values)
        out = (acc / denom).permute(0, 3, 1, 2, 4)
    else:
        out = torch.einsum("shgtc,schd->sthgd", p / denom, values)
    return out.reshape(s, t, hq, d).to(q.dtype)


_CHECKED = set()   # argument signatures whose shapes and dtypes passed


def _check_args(q, k_new, v_new, k_pool, v_pool, tables, start, n_valid,
                k_scale_pool, v_scale_pool, *, layer: int,
                kernel: bool) -> None:
    """Raise ValueError unless the arguments' shapes and dtypes are valid
    (``kernel``: also within the kernel's own limits). They depend on
    nothing else, so the wrapper runs them once per signature."""
    s, t, hq, d = q.shape
    check(k_new.shape == v_new.shape and k_new.shape[:2] == (s, t)
          and k_new.shape[3] == d, "k_new/v_new must be [S, T, Hkv, D]")
    hkv = k_new.shape[2]
    check(hq % hkv == 0, f"q heads {hq} not a multiple of kv heads {hkv}")
    check(k_pool.dim() == 5 and k_pool.shape == v_pool.shape
          and k_pool.shape[3:] == (hkv, d), "pools must be [L, N, BS, Hkv, D]")
    check(tables.dim() == 2 and tables.shape[0] == s, "tables must be [S, W]")
    check(start.shape == (s,) and n_valid.shape == (s,),
          "start and n_valid must be [S]")
    check(0 <= layer < k_pool.shape[0], f"layer {layer} out of range")
    bs = k_pool.shape[2]
    quant = k_scale_pool is not None or v_scale_pool is not None
    if quant:
        if t > bs:
            # The TPU kernel's scale append touches at most two pages, so
            # it refuses appends of more than a block; the port keeps the
            # same contract.
            raise ValueError(f"int8-KV append of {t} tokens exceeds the "
                             f"block size {bs}")
        l_, n_ = k_pool.shape[:2]
        check(k_scale_pool is not None and v_scale_pool is not None
              and k_scale_pool.shape == v_scale_pool.shape == (l_, n_, hkv, bs)
              and k_scale_pool.dtype == v_scale_pool.dtype == torch.float32,
              "int8 KV needs both scale pools, float32 [L, N, Hkv, BS]")
        check(k_pool.dtype == v_pool.dtype == torch.int8,
              "scale pools go with int8 pools")
        check(q.dtype == k_new.dtype == v_new.dtype and q.is_floating_point(),
              "q and the new rows must share one float dtype")
    else:
        check(t <= bs, "T must not exceed the block size")
        check(q.dtype == k_new.dtype == v_new.dtype == k_pool.dtype
              == v_pool.dtype, "q, the new rows and the pools must share a "
              "dtype")
    if kernel:
        check(q.dtype in _DTYPE_CODES, f"unsupported dtype {q.dtype}")
        check(d in _HEAD_DIMS, f"head dim {d} not in {_HEAD_DIMS}")
        check(not quant or t <= _MAX_NEW_INT8,
              f"the int8 kernel appends at most {_MAX_NEW_INT8} tokens per "
              "call")


def paged_append_attention(q: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor,
                           start: torch.Tensor, n_valid: torch.Tensor,
                           k_scale_pool: torch.Tensor | None = None,
                           v_scale_pool: torch.Tensor | None = None, *,
                           layer: int, scale: float) -> torch.Tensor:
    """Append ``k_new``/``v_new`` ``[S, T, Hkv, D]`` into layer ``layer`` of
    the pools ``[L, N, BS, Hkv, D]`` (in place) and return the attention
    output ``[S, T, Hq, D]`` of q ``[S, T, Hq, D]`` over each slot's pages.

    ``tables [S, W]`` int32 map a slot's pages to pool blocks; ``start``
    and ``n_valid`` ``[S]`` int32 give the tokens cached and the real new
    tokens of each slot. Callers keep ``start + n_valid <= W * BS`` for
    live slots. With ``k_scale_pool``/``v_scale_pool`` (fp32 ``[L, N, Hkv,
    BS]``) the pools are int8: the new rows are quantised per token and
    head on append (:func:`quantize_rows`) and attention dequantises in
    score space; q and the new rows keep their float dtype.

    Replaces the TPU kernel ``handwritten_ocr_tpu/ops/paged_decode_attention.py:
    _kernel``, both branches. On the H100 it is bound by bytes: a decode
    step (q ``[24, 1, 28, 128]``, pools ``[28, N, 128, 4, 128]``) reads
    each live slot's cached K and V once — about 1 KB per token per layer
    in bf16, 0.5 KB (+ 32 B of scales) in int8 — and does ~4 flops per
    bf16 byte read. The kernel reads only the pages below ``start +
    n_valid`` of live slots (a slot with n_valid 0 reads nothing), appends
    the new rows in the same launch, and takes the new cols from
    ``k_new``/``v_new`` (int8: quantised in the block's shared memory
    exactly as the append quantises them) rather than from the pool rows
    another block is writing. With bf16 q (both engines) it is one
    persistent launch of about one wave whose blocks derive the work from
    ``start``/``n_valid`` on the card (no host sync, so a decode step stays
    capturable in a CUDA graph): live (slot, kv-head, chunk of the
    context) items, the chunk length chosen from the live total of cols
    (:func:`plan`). One block serves all G·T query rows of its item
    (a ``mma.sync`` row tile per warp; at T = 1 the four warps share one
    tile and split its cols), streams K and V through a 3-stage
    ``cp.async`` ring of shared memory once (int8 tiles widened to bf16
    once per tile), runs both products on the tensor cores (P as bf16 hi
    + lo parts) and merges a pair's chunks in the same launch, in chunk
    order, through a self-resetting arrival counter in a per-device
    workspace. fp32 q (the card's reference runs) takes an FMA body of the
    same shape: the same work list and merge, one block of 8 warps for
    all G·T rows of its item (q rows in registers, a warp's row tile
    sharing each 64-col tile's cols with the other warps of its tile where
    there are few rows), K/V through a 3-stage ``cp.async`` ring (int8
    tiles widened to fp32 once, in shared memory).

    ``launches`` counts launches over fp pools, ``int8_launches`` over
    int8 pools, and ``fp32_launches`` those of the fp32 body (either
    pools): a bf16 fp-KV launch moves ``launches`` alone.
    """
    tensors = (q, k_new, v_new, k_pool, v_pool, tables, start, n_valid,
               k_scale_pool, v_scale_pool)
    kernel = use_kernel(*[x for x in tensors if x is not None])
    signature = (layer, kernel, *[None if x is None else (x.shape, x.dtype)
                                  for x in tensors])
    if signature not in _CHECKED:
        _check_args(*tensors, layer=layer, kernel=kernel)
        _CHECKED.add(signature)
    if not kernel:
        return paged_append_attention_plain(q, k_new, v_new, k_pool, v_pool,
                                            tables, start, n_valid,
                                            k_scale_pool, v_scale_pool,
                                            layer=layer, scale=scale)
    s, t, hq, d = q.shape
    hkv, bs = k_new.shape[2], k_pool.shape[2]
    quant = k_scale_pool is not None
    arrays = (q, k_new, v_new, k_pool, v_pool,
              *((k_scale_pool, v_scale_pool) if quant else ()))
    check(all(x.is_contiguous() for x in arrays),
          "q, the new rows and the pools must be contiguous")
    ptrs = [x.data_ptr() for x in arrays]
    check(all(p % 16 == 0 for p in ptrs),
          "q, the new rows and the pools must be 16-byte aligned")
    tables32, start32, valid32 = _int32(tables), _int32(start), _int32(n_valid)
    out = torch.empty_like(q)
    width = tables32.shape[1]
    kind = body(q.dtype, quant)
    launch = plan(s, t, hq, hkv, width * bs, kind,
                  build.sm_count(q.device.index))
    device = q.device
    part_acc = _WORKSPACE.take(device, torch.float32,
                               launch.partials * (d + 2)).data_ptr()
    part_ml = part_acc + launch.partials * d * 4
    counters = (_WORKSPACE.take(device, torch.int32,
                                launch.counters).data_ptr()
                if launch.counters else 0)
    build.launch(build.function("paged_decode_attention",
                                "hocr_paged_append_attention",
                                (ctypes.c_char_p,)),
                 _CALL.pack(*ptrs, *((0, 0) if not quant else ()),
                            tables32.data_ptr(), start32.data_ptr(),
                            valid32.data_ptr(), out.data_ptr(), part_acc,
                            part_ml, counters, build.current_stream(device),
                            s, t, hq, hkv, d, width, bs, k_pool.shape[1],
                            layer, launch.grid[0],
                            launch.threads // 32, launch.col_groups,
                            launch.min_chunk_tiles, launch.max_items,
                            launch.max_chunks, scale,
                            _DTYPE_CODES[q.dtype]))
    if quant:
        paged_append_attention.int8_launches += 1
    else:
        paged_append_attention.launches += 1
    if kind == "fp32":
        paged_append_attention.fp32_launches += 1
    return out


paged_append_attention.launches = 0
paged_append_attention.int8_launches = 0
paged_append_attention.fp32_launches = 0
