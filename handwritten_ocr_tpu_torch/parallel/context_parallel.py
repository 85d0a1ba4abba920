"""Context-parallel (ring) attention: sequence-sharded attention over the
ranks of one mesh axis.

Port of ``handwritten_ocr_tpu/parallel/context_parallel.py``. Each rank
holds one contiguous chunk ``[B, S/n, H, D]`` of q, k and v; the K/V
chunks travel around the ring, one hop per step, so no rank ever holds
the whole sequence's keys:

- n ring steps. At step s, the rank holding query chunk i attends to kv
  chunk j = (i - s) mod n and merges the result into its running
  online-softmax triple (m, l, acc), kept in fp32 whatever the input
  dtype, so the result equals one-device attention to fp tolerance.
- Causal mode skips the chunks above the diagonal (j > i), whose
  contribution is masked anyway; the rotation still runs between every
  two steps, so every rank issues the same sends and receives (the JAX
  loop's n-th rotation, which only restores the placement, is left
  out: the port returns no k/v).
- A step's send and receive are one ``dist.batch_isend_irecv`` to the
  next rank and from the previous one. On cards that needs NCCL (gloo
  sends no CUDA tensors); on the CPU gloo carries it.

As in the JAX package each chunk pair is plain tensor arithmetic
(``_chunk_attention``), not a kernel.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from handwritten_ocr_tpu_torch.parallel.mesh import axis_rank, axis_size


def _chunk_attention(q, k, v, scale: float, row_offset: int,
                     col_offset: int, causal: bool):
    """Blockwise attention of one (q-chunk, kv-chunk) pair.

    q: [B, Sq, H, D]; k/v: [B, Sk, H, D] (kv already group-expanded for
    GQA). Returns the unnormalized online-softmax triple (m [B, Sq, H,
    1], l [B, Sq, H, 1], acc [B, Sq, H, D]) in fp32, with causal masking
    by absolute position (the offsets are the chunks' global offsets)."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        rows = row_offset + torch.arange(q.shape[1], device=q.device)[:, None]
        cols = col_offset + torch.arange(k.shape[1], device=q.device)[None, :]
        scores = scores.masked_fill(~(cols <= rows), float("-inf"))
    m = torch.clamp(scores.amax(dim=-1, keepdim=True), min=-3.4e38)
    p = torch.exp(scores - m)            # exp(-inf) = 0 on masked entries
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return m.transpose(1, 2), l.transpose(1, 2), acc


def _merge(state, delta):
    """Merge two online-softmax partial states."""
    m0, l0, acc0 = state
    m1, l1, acc1 = delta
    m = torch.maximum(m0, m1)
    a0, a1 = torch.exp(m0 - m), torch.exp(m1 - m)
    return m, a0 * l0 + a1 * l1, a0 * acc0 + a1 * acc1


def _rotate(tensors, group, send_to: int, recv_from: int):
    """Send each tensor to ``send_to`` and receive its successor from
    ``recv_from`` (global ranks) in one batch; returns the received."""
    received = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, send_to, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, r, recv_from, group) for r in received]
    for request in dist.batch_isend_irecv(ops):
        request.wait()
    return received


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh, axis: str = "data", causal: bool = False,
                   scale: float | None = None) -> torch.Tensor:
    """Attention over a sequence split across the ranks of ``axis``.

    q ``[B, S, Hq, D]``, k/v ``[B, S, Hkv, D]``: the whole sequence, the
    same on every rank of the axis (as the JAX function's unsharded
    inputs); S must divide by the axis size n. A rank keeps only its
    chunk of S/n rows, runs the ring, and returns its chunk of the
    output, rows ``[i·S/n, (i+1)·S/n)`` of ``[B, S, Hq, D]``, in q's
    dtype. GQA repeats the kv heads inside each rank's chunk."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    n = axis_size(mesh, axis)
    if s % n:
        raise ValueError(f"sequence {s} not divisible by {axis}={n}")
    if scale is None:
        scale = d ** -0.5
    chunk = s // n
    idx = axis_rank(mesh, axis)
    rows = slice(idx * chunk, (idx + 1) * chunk)
    q_c = q[:, rows]
    k_r, v_r = k[:, rows].contiguous(), v[:, rows].contiguous()
    group = mesh.get_group(axis) if n > 1 else None
    if group is not None:
        send_to = dist.get_global_rank(group, (idx + 1) % n)
        recv_from = dist.get_global_rank(group, (idx - 1) % n)
    state = (torch.full((b, chunk, hq, 1), float("-inf"), device=q.device),
             torch.zeros((b, chunk, hq, 1), device=q.device),
             torch.zeros((b, chunk, hq, d), device=q.device))
    for step in range(n):
        src = (idx - step) % n                 # whose kv this rank holds
        if not (causal and src > idx):
            k_c = torch.repeat_interleave(k_r, hq // hkv, dim=2)
            v_c = torch.repeat_interleave(v_r, hq // hkv, dim=2)
            state = _merge(state, _chunk_attention(
                q_c, k_c, v_c, scale, idx * chunk, src * chunk, causal))
        if group is not None and step + 1 < n:
            k_r, v_r = _rotate((k_r, v_r), group, send_to, recv_from)
    _, l, acc = state
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
