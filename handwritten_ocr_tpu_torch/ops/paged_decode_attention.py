"""Fused append + paged GQA attention: the decode step's attention.

Port of ``handwritten_ocr_tpu/ops/paged_decode_attention.py`` for a
full-precision KV cache. CUDA tensors go to the hand-written kernel
``csrc/paged_decode_attention.cu``; CPU tensors to
:func:`paged_append_attention_plain`. Both update the pools IN PLACE,
where the JAX kernel returns them aliased.
"""

from __future__ import annotations

import ctypes

import torch

from handwritten_ocr_tpu_torch.ops import build
from handwritten_ocr_tpu_torch.ops.dispatch import check, use_kernel

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (128,)        # the text model's head width
# Context cols per block of the kernel's split over the context (a
# multiple of its 64-col key tile): at a 1k-token decode this gives each
# live (slot, kv-head) 4 blocks, enough blocks to spread over the SMs.
_SPLIT_COLS = 256


def _append_plain(k_new, v_new, k_pool, v_pool, tables, start, n_valid,
                  layer: int) -> None:
    """Write token i < n_valid[s] of each slot at min(start + i, cap)."""
    s, t = k_new.shape[:2]
    bs = k_pool.shape[2]
    cap = tables.shape[1] * bs - 1
    tok = torch.arange(t, device=k_new.device)
    valid = tok[None, :] < n_valid[:, None]
    pos = torch.clamp(start[:, None].long() + tok[None, :], max=cap)
    blocks = torch.take_along_dim(tables.long(), pos // bs, dim=1)
    rows, toks = valid.nonzero(as_tuple=True)
    k_pool[layer, blocks[rows, toks], (pos % bs)[rows, toks]] = \
        k_new[rows, toks].to(k_pool.dtype)
    v_pool[layer, blocks[rows, toks], (pos % bs)[rows, toks]] = \
        v_new[rows, toks].to(v_pool.dtype)


def paged_append_attention_plain(q, k_new, v_new, k_pool, v_pool, tables,
                                 start, n_valid, *, layer: int,
                                 scale: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch: append, gather the slot's
    pages, fp32 attention where query token i sees cols <= start + i;
    rows i >= n_valid (and every row of an n_valid == 0 slot) are 0."""
    s, t, hq, d = q.shape
    hkv = k_new.shape[2]
    group = hq // hkv
    _append_plain(k_new, v_new, k_pool, v_pool, tables, start, n_valid, layer)
    width = tables.shape[1] * k_pool.shape[2]
    idx = tables.long()
    keys = k_pool[layer][idx].reshape(s, width, hkv, d).float()
    values = v_pool[layer][idx].reshape(s, width, hkv, d).float()
    qf = (q.float() * scale).reshape(s, t, hkv, group, d)
    scores = torch.einsum("sthgd,schd->shgtc", qf, keys)
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
    out = torch.einsum("shgtc,schd->sthgd", p / denom, values)
    return out.reshape(s, t, hq, d).to(q.dtype)


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
    live slots.

    Replaces the TPU kernel ``handwritten_ocr_tpu/ops/paged_decode_attention.py:
    _kernel`` (fp-KV branch). On the H100 it is bound by bytes: a decode
    step (q ``[24, 1, 28, 128]``, bf16 pools ``[28, N, 128, 4, 128]``)
    reads each live slot's cached K and V once — about 1 KB per token per
    layer — and does ~4 flops per byte read. The kernel reads only the
    pages below ``start + n_valid`` of live slots (a slot with n_valid 0
    reads nothing), splits each context over blocks of 256 cols so that a
    few live slots still spread over the SMs (a second small kernel merges
    the splits), appends the new rows in the same launch, and takes the
    new cols straight from ``k_new``/``v_new``.
    """
    if k_scale_pool is not None or v_scale_pool is not None:
        raise NotImplementedError("int8 KV: next slice")
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
    check(t <= k_pool.shape[2], "T must not exceed the block size")
    check(q.dtype == k_new.dtype == v_new.dtype == k_pool.dtype
          == v_pool.dtype, "q, the new rows and the pools must share a dtype")
    if not use_kernel(q, k_new, v_new, k_pool, v_pool, tables, start, n_valid):
        return paged_append_attention_plain(q, k_new, v_new, k_pool, v_pool,
                                            tables, start, n_valid,
                                            layer=layer, scale=scale)
    check(q.dtype in _DTYPE_CODES, f"unsupported dtype {q.dtype}")
    check(d in _HEAD_DIMS, f"head dim {d} not in {_HEAD_DIMS}")
    check(all(x.is_contiguous() for x in (q, k_new, v_new, k_pool, v_pool)),
          "q, the new rows and the pools must be contiguous")
    check(all(x.data_ptr() % 16 == 0 for x in (k_new, v_new, k_pool, v_pool)),
          "the new rows and the pools must be 16-byte aligned")
    tables32 = tables.to(torch.int32).contiguous()
    start32 = start.to(torch.int32).contiguous()
    valid32 = n_valid.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    width = tables32.shape[1]
    n_split = -(-width * k_pool.shape[2] // _SPLIT_COLS)
    partials = s * hkv * (hq // hkv) * t * n_split
    part_acc = torch.empty(partials * d, dtype=torch.float32, device=q.device)
    part_ml = torch.empty(partials * 2, dtype=torch.float32, device=q.device)
    fn = build.load("paged_decode_attention").hocr_paged_append_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    build.launch(fn, q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                 k_pool.data_ptr(), v_pool.data_ptr(), tables32.data_ptr(),
                 start32.data_ptr(), valid32.data_ptr(), out.data_ptr(),
                 part_acc.data_ptr(), part_ml.data_ptr(),
                 s, t, hq, hkv, d, width, k_pool.shape[2], k_pool.shape[1],
                 int(layer), _SPLIT_COLS, float(scale), _DTYPE_CODES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    paged_append_attention.launches += 1
    return out


paged_append_attention.launches = 0
