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
"""

from __future__ import annotations

from typing import Any

import torch

from handwritten_ocr_tpu_torch.parallel.mesh import axis_rank, axis_size

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
    """This rank's slice of one leaf, in a tensor of its own (the full
    leaf can be freed)."""
    if "model" not in spec:
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


def shard_params(mesh, params: Any, fsdp: bool = False,
                 prefix: tuple[str, ...] = ()):
    """This rank's slices of ``params`` under the TP specs over the
    mesh's "model" axis (``prefix`` as in :func:`param_shardings`).
    Every rank must hold the same full tree. Replicated leaves stay the
    same tensors."""
    if fsdp:
        raise NotImplementedError(
            "FSDP serving (shard(fsdp=True)) is not ported yet; see "
            "ROADMAP.md, section A")
    tp, rank = axis_size(mesh, "model"), axis_rank(mesh, "model")
    if tp == 1:
        return params
    return _map(lambda path, leaf: _slice(
        path, leaf, _spec_for_path(path, tuple(leaf.shape), False), tp, rank),
        params, prefix)
