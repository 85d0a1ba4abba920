"""Tensor-parallel sharding of the parameter trees.

Port of ``handwritten_ocr_tpu/parallel/sharding.py``: the same Megatron
rules over the "model" axis, one spec per leaf:

  column-parallel (shard out-features): q/k/v/qkv, gate/up, merger fc1
  row-parallel    (shard in-features):  o, proj(vision), down, fc2
  vocab-parallel:                       embed (rows), lm_head (out rows)
  column-parallel:                      patch_embed (out-features)
  replicated:                           norms, biases of row-parallel layers

A spec is a tuple naming the mesh axis of each dimension of the leaf as
the port stores it (None: not split). The port keeps linear weights as
``[out, in]`` where the JAX package keeps ``[in, out]``, and keeps a list
of layers where JAX stacks them into a leading ``[L]`` axis; a spec names
the same LOGICAL dimension as JAX's: JAX's ``P(None, None, "model")`` of
a stacked q weight ``[L, in, out]`` is the port's ``("model", None)`` of
each layer's ``[out, in]``.

Where XLA inserts the collectives in the JAX package, the port's forward
(``models/``) calls them itself over the rank's model group: one
all-reduce after each row-parallel product, one after the vocab-parallel
embedding lookup, one gather of the column-parallel patch embedding, and
the merged top-k of ``models/layers.py:topk_ids`` over the vocab shards.

The fused vision qkv ``[3·D, D]`` keeps JAX's spec, but a rank holds its
heads' q, k and v rows (each third split alike), not a contiguous third
of the fused matrix: its packed projection is then ``3·(H/tp)·hd`` wide,
the window kernel's layout at H/tp heads.

FSDP (``fsdp=True``, ZeRO-3): each leaf's largest dimension that the TP
spec leaves whole is split over "data" as well (JAX's ``_add_fsdp``), and
a rank keeps its contiguous "data" block of its TP slice. JAX picks that
dimension on the stacked ``[L, ...]`` leaf, the port on each layer's own
leaf, so the blocks may differ from JAX's; put back together they are
the same TP slice. A forward gathers each layer's blocks just before it
uses them (:class:`LayerGather`, one all-reduce a leaf over the "data"
group, ``parallel/collectives.py:gather_data``) and drops them after; the
gradients of the gathered leaves are summed over "data" and each rank
keeps its block. The gathers need the specs of the tree before it was
sliced over "data" (:func:`param_shardings` of the whole or the TP-sliced
tree: they are the same).
"""

from __future__ import annotations

from typing import Any

import torch

from handwritten_ocr_tpu_torch.parallel.collectives import gather_data
from handwritten_ocr_tpu_torch.parallel.mesh import (axis_rank, axis_size,
                                                     data_group)

_COLUMN_PARALLEL = {"q", "k", "v", "qkv", "gate", "up", "fc1"}
_ROW_PARALLEL = {"o", "proj", "down", "fc2"}


def _spec_for_path(path: tuple[str, ...], shape: tuple[int, ...],
                   fsdp: bool) -> tuple:
    names = [p for p in path if not p.isdigit()]
    leaf = names[-1]                     # "w" | "b" | "scale" | quantized
    # Quantized leaves shard like their bf16 counterparts.
    leaf = {"w_q": "w", "w_scale": "b"}.get(leaf, leaf)
    parent = names[-2] if len(names) >= 2 else ""

    if parent == "embed":
        spec = ("model", None)           # vocab rows
    elif parent in ("lm_head", "patch_embed") or parent in _COLUMN_PARALLEL:
        spec = ("model", None) if leaf == "w" else ("model",)  # out rows
    elif parent in _ROW_PARALLEL:
        spec = (None, "model") if leaf == "w" else (None,)     # in columns
    else:                                # norms, misc
        spec = (None,) * len(shape)

    if fsdp:
        spec = _add_fsdp(spec, shape)
    return spec


def _add_fsdp(spec: tuple, shape: tuple[int, ...]) -> tuple:
    """Shard the largest not-yet-sharded dim over "data" (ZeRO-3)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    free = [i for i, p in enumerate(parts) if p is None]
    if not free:
        return spec
    target = max(free, key=lambda i: shape[i])
    if shape[target] < 2:
        return spec
    parts[target] = "data"
    return tuple(parts)


def _map(fn, node, path: tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a tree of dicts and lists (list indices
    enter the path as digits, as JAX's flattened keys do)."""
    if isinstance(node, dict):
        return {k: _map(fn, v, path + (str(k),)) for k, v in node.items()}
    if isinstance(node, list):
        return [_map(fn, v, path + (str(i),)) for i, v in enumerate(node)]
    return fn(path, node)


def param_shardings(mesh, params: Any, fsdp: bool = False,
                    prefix: tuple[str, ...] = ()):
    """A tree of specs matching ``params``' structure (``prefix``: the
    path of ``params`` inside its model's tree, for a subtree)."""
    return _map(lambda path, leaf: _spec_for_path(path, tuple(leaf.shape),
                                                  fsdp), params, prefix)


def data_sharding(mesh, ndim: int, batch_axis: int = 0) -> tuple:
    """The spec of one array whose batch axis splits over "data"."""
    parts = [None] * ndim
    parts[batch_axis] = "data"
    return tuple(parts)


def replicated(mesh) -> tuple:
    """The spec of an array every rank holds whole."""
    return ()


def _slice(path: tuple[str, ...], leaf: torch.Tensor, spec: tuple,
           tp: int, rank: int) -> torch.Tensor:
    """This rank's slice of one leaf over "model", in a tensor of its own
    (the full leaf can be freed)."""
    if "model" not in spec or tp == 1:
        return leaf
    dim = spec.index("model")
    n = leaf.shape[dim]
    fused = "qkv" in path
    parts = 3 * tp if fused else tp
    if n % parts:
        raise ValueError(f"{'/'.join(path)}: dimension {dim} of "
                         f"{tuple(leaf.shape)} does not split {parts} ways")
    if fused:   # each of q, k, v split alike: this rank's heads of each
        part = leaf.unflatten(dim, (3, tp, n // parts)).select(dim + 1, rank)
        return part.flatten(dim, dim + 1).clone(
            memory_format=torch.contiguous_format)
    return leaf.narrow(dim, rank * (n // tp), n // tp).clone(
        memory_format=torch.contiguous_format)


def _slice_data(path: tuple[str, ...], leaf: torch.Tensor, spec: tuple,
                data: int, rank: int) -> torch.Tensor:
    """This rank's contiguous "data" block of one (TP-sliced) leaf."""
    if "data" not in spec or data == 1:
        return leaf
    dim = spec.index("data")
    n = leaf.shape[dim]
    if n % data:
        raise ValueError(f"{'/'.join(path)}: dimension {dim} of "
                         f"{tuple(leaf.shape)} does not split {data} ways "
                         f"over \"data\"")
    return leaf.narrow(dim, rank * (n // data), n // data).clone(
        memory_format=torch.contiguous_format)


def shard_params(mesh, params: Any, fsdp: bool = False,
                 prefix: tuple[str, ...] = (), model_sliced: bool = False):
    """This rank's slices of ``params`` under the TP specs over the
    mesh's "model" axis and, with ``fsdp``, its "data" blocks of them
    (``prefix`` as in :func:`param_shardings`). Every rank must hold the
    same full tree; ``model_sliced``: the tree holds the rank's TP slices
    already (``models/init.py`` with ``mesh``), and only the "data" blocks
    are taken. Leaves that need no slicing stay the same tensors; a leaf
    whose dimension does not split raises, naming the leaf."""
    tp, rank = axis_size(mesh, "model"), axis_rank(mesh, "model")
    data, data_rank = axis_size(mesh, "data"), axis_rank(mesh, "data")
    if model_sliced:
        tp = 1
    if tp == 1 and not (fsdp and data > 1):
        return params

    def one(path, leaf):
        spec = _spec_for_path(path, tuple(leaf.shape), fsdp)
        return _slice_data(path, _slice(path, leaf, spec, tp, rank), spec,
                           data if fsdp else 1, data_rank)

    return _map(one, params, prefix)


def _zip_map(fn, node, specs):
    """``fn(leaf, spec)`` over a tree and its spec tree."""
    if isinstance(node, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in node.items()}
    if isinstance(node, list):
        return [_zip_map(fn, v, s) for v, s in zip(node, specs, strict=True)]
    return fn(node, specs)


class LayerGather:
    """The gather of an FSDP tree, one layer at a time: ``gather(tree,
    *keys)`` is the subtree ``tree`` found at ``keys`` of the model's tree,
    each "data" block put back together over the "data" group (the rank's
    TP slice again); other leaves come back as they are. Differentiable:
    a gathered leaf's gradient is summed over "data" and its block kept.
    ``specs``: :func:`param_shardings` of the tree with ``fsdp=True``."""

    def __init__(self, group, specs):
        self.group, self.specs = group, specs

    def scope(self, *keys) -> "LayerGather":
        """The gather of the subtree at ``keys`` (its keys start there)."""
        specs = self.specs
        for key in keys:
            specs = specs[key]
        return LayerGather(self.group, specs)

    def __call__(self, tree, *keys):
        return _zip_map(
            lambda leaf, spec: (gather_data(leaf, spec.index("data"),
                                            self.group)
                                if "data" in spec else leaf),
            tree, self.scope(*keys).specs)


def layer_gather(mesh, specs) -> LayerGather | None:
    """The :class:`LayerGather` of a tree sharded with ``fsdp=True`` over
    ``mesh`` whose specs are ``specs``; None when nothing was split over
    "data" (no specs, or a "data" axis of 1)."""
    group = data_group(mesh)
    if specs is None or group is None:
        return None
    return LayerGather(group, specs)


def gathered(gather: LayerGather | None, tree, *keys):
    """``gather(tree, *keys)``, or ``tree`` itself without FSDP."""
    return tree if gather is None else gather(tree, *keys)


def scoped(gather: LayerGather | None, *keys) -> LayerGather | None:
    """``gather.scope(*keys)``, or None without FSDP."""
    return None if gather is None else gather.scope(*keys)


def split_over_data(specs):
    """A tree of bools shaped like ``specs``: True where the leaf's spec
    names "data" (FSDP splits it; its gradient is summed by its gather)."""
    return _map(lambda path, spec: "data" in spec, specs)
