"""Shared transformer building blocks (port of ``models/layers.py``).

Numerics follow the JAX package: RMSNorm statistics in fp32 with a cast
back, fp32 softmax, rotary embedding in fp32 (or in bf16 for bf16 inputs,
the fast path, unless ``HOCR_TPU_ROPE_FP32`` is set). Parameters are
plain dicts of tensors in PyTorch's layout:

  linear:  {"w": [out, in], optional "b": [out]}   (JAX stores w as [in, out])
           or weight-only int8 {"w_q": int8 [out, in], "w_scale": f32 [out]}
  rmsnorm: {"scale": [dim]}

Tensor parallelism (``parallel/sharding.py``): a ``group`` argument is
the rank's "model" process group, None on one device (every function then
runs exactly as without it). A row-parallel product sums the ranks'
partials with one all-reduce before its replicated bias; the
vocab-parallel embedding zeroes the rows outside the rank's range and
all-reduces; logits stay split by vocabulary, and :func:`topk_ids` /
:func:`argmax_ids` merge the ranks' candidates. Every collective is an
``all_reduce`` in the tensor's own dtype, which NCCL and gloo (the CPU,
and ranks sharing one card) both run on CUDA tensors, through the
differentiable Functions of ``parallel/collectives.py`` (the sharded
training step differentiates them; serving's values are the same).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
import torch.nn.functional as F

from handwritten_ocr_tpu_torch.ops.int8_matmul import (MAX_ROWS, int8_matmul,
                                                       int8_matmul_supported)
from handwritten_ocr_tpu_torch.parallel.collectives import (copy_to_group,
                                                            gather_from_group,
                                                            reduce_from_group)


def rms_norm(params: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with fp32 statistics (HF Qwen2RMSNorm semantics)."""
    dtype = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (params["scale"] * normed.to(dtype)).to(dtype)


def linear(params: dict, x: torch.Tensor, group=None) -> torch.Tensor:
    """``x @ w^T + b``. With ``group`` the layer is row-parallel: the
    rank's partial product (rounded to x's dtype) is summed over the
    group, then the replicated bias is added once."""
    if "w_q" in params:  # weight-only int8 (models/quant.py)
        out = _quantized_matmul(params, x)
    else:
        out = x @ params["w"].t()
    out = reduce_from_group(out, group)
    if "b" in params:
        out = out + params["b"]
    return out


def _quantized_matmul(params: dict, x: torch.Tensor) -> torch.Tensor:
    """int8-weight product: decode-shaped calls (at most 32 rows) go to the
    int8 kernel, which reads each weight once as 1 byte; larger calls
    (prefill) are bound by operations and take the dequantised product,
    as the JAX package computes them outside its kernel."""
    w_q, scale = params["w_q"], params["w_scale"]
    lead = x.numel() // x.shape[-1]
    if lead <= MAX_ROWS and int8_matmul_supported(w_q.shape[1], w_q.shape[0]):
        out = int8_matmul(x.reshape(lead, x.shape[-1]).contiguous(), w_q, scale)
        return out.reshape(*x.shape[:-1], w_q.shape[0])
    return (x @ w_q.to(x.dtype).t()) * scale.to(x.dtype)


def swiglu_mlp(params: dict, x: torch.Tensor, group=None) -> torch.Tensor:
    """gate/up/down MLP with a SiLU gate (Qwen2MLP / Qwen2_5_VLMLP);
    gate/up column-parallel and down row-parallel under ``group`` (the
    replicated ``x`` enters them through "f")."""
    x = copy_to_group(x, group)
    return linear(params["down"],
                  F.silu(linear(params["gate"], x)) * linear(params["up"], x),
                  group)


def gelu_mlp(params: dict, x: torch.Tensor, group=None) -> torch.Tensor:
    """fc1 → exact GELU → fc2 (vision patch merger MLP); fc1
    column-parallel and fc2 row-parallel under ``group`` (the replicated
    ``x`` enters fc1 through "f")."""
    x = copy_to_group(x, group)
    return linear(params["fc2"],
                  F.gelu(linear(params["fc1"], x), approximate="none"), group)


def group_size(group) -> int:
    """Ranks in a model group (1 for None: one device)."""
    return 1 if group is None else dist.get_world_size(group)


def embed(params: dict, ids: torch.Tensor, group=None) -> torch.Tensor:
    """Rows of the embedding table ``params["w"] [V, D]`` for ``ids``.
    Under ``group`` the table is split by rows (vocab-parallel): a rank
    holds rows ``[rank·V/tp, (rank+1)·V/tp)``, looks up the ids in its
    range, zeroes the others, and the sum over the group gives every
    rank the full rows (exactly: each sum has one non-zero term)."""
    w = params["w"]
    if group is None:
        return w[ids]
    local = ids - dist.get_rank(group) * w.shape[0]
    mine = (local >= 0) & (local < w.shape[0])
    out = w[torch.where(mine, local, 0)].masked_fill(~mine[..., None], 0)
    return reduce_from_group(out, group)


def gather_columns(x: torch.Tensor, group) -> torch.Tensor:
    """The full last axis of a tensor split over ``group`` by contiguous
    column blocks (rank r holds block r): each rank writes its block into
    a zeroed buffer and one all-reduce sums them (an all-gather that
    gloo also runs on CUDA tensors); the gradient's block of this rank
    flows back."""
    return gather_from_group(x, group, dim=-1)


def topk_ids(logits: torch.Tensor, k: int, group=None) -> torch.Tensor:
    """Ids [..., k] of the ``k`` largest of fp32 ``logits [..., V]``,
    value-descending and index-ascending on ties (``jax.lax.top_k``'s
    order; ``torch.topk`` gives ties in no order). Each logit becomes one
    unique int64 key, its order-preserving int32 image in the high half
    and V - 1 - index in the low half, so the top-k of the keys is exact;
    it all stays on the device.

    Under ``group`` the logits are the rank's vocab shard (rank r holds
    ids ``[r·V/tp, (r+1)·V/tp)``): each rank keys its shard with GLOBAL
    ids, takes its local top-k, the ranks exchange those k keys (one
    all-reduce of a zeroed ``[tp, ..., k]`` buffer), and a second top-k
    picks the result: exactly the ids of the whole vocabulary's top-k,
    ties included, without gathering the logits."""
    local_vocab = logits.shape[-1]
    world, offset = 1, 0
    if group is not None:
        world = dist.get_world_size(group)
        offset = dist.get_rank(group) * local_vocab
    vocab = world * local_vocab
    bits = logits.float().contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    low = vocab - 1 - offset - torch.arange(local_vocab, device=logits.device)
    top = torch.topk(ordered * (1 << 32) + low, min(k, local_vocab),
                     dim=-1).values
    if group is not None:
        top = gather_columns(top, group)
        top = torch.topk(top, k, dim=-1).values
    return vocab - 1 - (top & 0xFFFFFFFF)


def argmax_ids(logits: torch.Tensor, group=None) -> torch.Tensor:
    """Greedy ids [...] (int32) of fp32 ``logits [..., V]``: the first
    index of the largest value, as ``torch.argmax``; under ``group`` over
    the vocab shards through :func:`topk_ids` (same ids)."""
    if group is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return topk_ids(logits, 1, group)[..., 0].to(torch.int32)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def rope_fp32() -> bool:
    """Whether bf16 rope computes in fp32: ``HOCR_TPU_ROPE_FP32`` set and
    non-empty, read at each call, as the JAX package does."""
    return bool(os.environ.get("HOCR_TPU_ROPE_FP32"))


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotary application (HF apply_rotary_pos_emb semantics).

    q/k: [..., T, H, D]; cos/sin broadcastable to [..., T, 1, D]. bf16
    inputs compute in bf16 (the fast path, within 1 bf16 ulp of the exact
    result) unless ``HOCR_TPU_ROPE_FP32`` is set and non-empty (read at
    each call, as the JAX package does): then, as every other dtype, in
    fp32 (the exact path). The window kernel and its plain version rope
    in their own way whatever the variable says, as JAX's window kernel
    does.
    """
    fast = q.dtype == torch.bfloat16 and not rope_fp32()
    compute = q.dtype if fast else torch.float32
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
