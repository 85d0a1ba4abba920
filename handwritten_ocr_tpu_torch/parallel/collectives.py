"""Differentiable collectives of the sharded forward (Megatron's "f" and
"g", and the gathers of tensor and fully sharded data parallelism).

Where the JAX package lets GSPMD insert a collective and differentiate
it, the port calls these ``torch.autograd.Function``s: each runs the
collective forward and its conjugate backward. Every one is built from
``all_reduce`` of the tensor in its own dtype, so NCCL and gloo (the CPU,
and ranks sharing one card) run one code path on CUDA tensors; a gather
writes the rank's block into a zeroed buffer and sums the buffer (exact:
each element has one non-zero term, also for int8).

  :func:`copy_to_group`     "f": identity forward, all-reduce backward.
                            Where a replicated activation enters a
                            column-parallel product, the ranks' partial
                            gradients of it are summed.
  :func:`reduce_from_group` "g": all-reduce forward, identity backward.
                            After a row-parallel product or a
                            vocab-parallel lookup.
  :func:`gather_from_group` all-gather of contiguous blocks of one
                            dimension forward, the rank's block of the
                            gradient backward.
  :func:`gather_data`       the same gather over the "data" group (FSDP):
                            its backward sums the gradient over the group
                            and keeps the rank's block, a reduce-scatter.

With ``group`` None (one rank along the axis) each returns its input.

Under :func:`regather_in_backward` a leaf that :func:`gather_data`
gathered is saved for the backward as the rank's block, and gathered
again when the backward reads it (ZeRO-3): a layer's whole weights then
live only while the layer runs, forward and backward, instead of all of
them from the forward to the backward.
"""

from __future__ import annotations

import contextlib
import weakref

import torch
import torch.distributed as dist

# the gathers of the innermost regather_in_backward: storage address of a
# gathered tensor -> (a weak reference to it, its block, dim, group)
_REGATHER: list[dict] = []


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' blocks of ``x`` along ``dim`` (rank r holds block r),
    through one all-reduce of a zeroed ``[world, *x.shape]`` buffer."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    full = x.new_zeros((world, *x.shape))
    full[rank] = x
    dist.all_reduce(full, group=group)
    return full.movedim(0, dim).flatten(dim, dim + 1)


def _block(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's contiguous block of ``x`` along ``dim``."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    return x.unflatten(dim, (world, -1)).select(dim, rank).contiguous()


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        dist.all_reduce(x, group=group)
        ctx.mark_dirty(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _block(grad, ctx.dim, ctx.group), None, None


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return _block(grad, ctx.dim, ctx.group), None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's "f": ``x`` itself; its gradient summed over ``group``."""
    if group is None or not torch.is_grad_enabled() or not x.requires_grad:
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's "g": the sum of the ranks' ``x`` over ``group``, in
    place (``x`` is a fresh partial product); the gradient passes
    unchanged."""
    if group is None:
        return x
    if not torch.is_grad_enabled() or not x.requires_grad:
        dist.all_reduce(x, group=group)
        return x
    return _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The ranks' contiguous blocks of ``dim`` put together (rank r's
    block r); the gradient's block of this rank flows back."""
    if group is None:
        return x
    dim = dim % x.dim()
    if not torch.is_grad_enabled() or not x.requires_grad:
        return _gather(x, dim, group)
    return _GatherFromGroup.apply(x, dim, group)


def gather_data(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """FSDP's gather of one leaf over the "data" ``group`` along ``dim``;
    the gradient is summed over the group and this rank keeps its block
    (the reduce-scatter of ZeRO-3)."""
    if group is None:
        return x
    if not torch.is_grad_enabled() or not x.requires_grad:
        return _gather(x, dim, group)
    full = _GatherData.apply(x, dim, group)
    if _REGATHER:
        _REGATHER[-1][full.untyped_storage().data_ptr()] = (
            weakref.ref(full), x.detach(), dim, group)
    return full


def _pack(tensor: torch.Tensor):
    entry = _REGATHER[-1].get(tensor.untyped_storage().data_ptr())
    if entry is None or entry[0]() is None:
        return tensor
    _, block, dim, group = entry
    return (block, dim, group, tensor.size(), tensor.stride(),
            tensor.storage_offset())


def _unpack(packed):
    if isinstance(packed, torch.Tensor):
        return packed
    block, dim, group, size, stride, offset = packed
    return _gather(block, dim, group).as_strided(size, stride, offset)


@contextlib.contextmanager
def regather_in_backward():
    """Inside it, autograd saves what :func:`gather_data` gathers (and
    views of it) as the rank's block; the backward gathers it again (one
    all-reduce over the "data" group each time it reads one). Every rank
    of the group runs the same graph, so the gathers meet in order."""
    _REGATHER.append({})
    try:
        with torch.autograd.graph.saved_tensors_hooks(_pack, _unpack):
            yield
    finally:
        _REGATHER.pop()
