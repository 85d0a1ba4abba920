"""Carry a JAX-layout parameter tree over to the port's layout.

The JAX package (``models/init.py:init_vl``, ``models/weights.py:convert_vl``)
keeps linear weights as ``[in, out]`` and stacks the layers of a tower into
``[L, ...]`` arrays. The port keeps PyTorch's ``[out, in]`` layout and a
list of per-layer dicts, so its forward is a Python loop over layers.
"""

from __future__ import annotations

import numpy as np
import torch

# Subtrees whose leaves carry a leading layer axis in the JAX layout.
_STACKED = ("blocks", "layers")
# Subtrees whose "w" is a lookup table, not a linear weight.
_TABLES = ("embed",)


def _tensor(array, device, dtype) -> torch.Tensor:
    array = np.asarray(array)
    if array.dtype.name == "bfloat16":        # ml_dtypes bf16: go through fp32
        tensor = torch.from_numpy(array.astype(np.float32)).to(torch.bfloat16)
    else:
        tensor = torch.from_numpy(np.array(array))      # a writable copy
    if dtype is not None and tensor.is_floating_point():
        tensor = tensor.to(dtype)
    return tensor.to(device)


def _convert(node, name: str, device, dtype):
    if not isinstance(node, dict):
        return _tensor(node, device, dtype)
    out = {key: _convert(value, key, device, dtype)
           for key, value in node.items()}
    if "w" in out and name not in _TABLES:
        out["w"] = out["w"].transpose(-1, -2).contiguous()
    return out


def _unstack(node, index: int):
    if isinstance(node, dict):
        return {key: _unstack(value, index) for key, value in node.items()}
    return node[index].contiguous()


def _depth(node) -> int:
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return node.shape[0]


def from_jax_params(tree: dict, device: str | torch.device = "cpu",
                    dtype: torch.dtype | None = None) -> dict:
    """The port's parameters from a JAX tree of numpy arrays.

    ``tree`` has the ``init_vl`` / ``convert_vl`` layout (``{"vision":
    ..., "text": ...}``, or a lone text tree). Every linear weight comes
    out transposed to ``[out, in]``; stacked ``blocks``/``layers`` come
    out as lists of per-layer dicts; everything else is unchanged. With
    ``dtype`` set, floating tensors are cast to it.
    """
    def walk(node, name):
        if isinstance(node, dict) and name in _STACKED:
            stacked = _convert(node, name, device, dtype)
            return [_unstack(stacked, i) for i in range(_depth(stacked))]
        if isinstance(node, dict) and not ("w" in node and name):
            return {key: walk(value, key) for key, value in node.items()}
        return _convert(node, name, device, dtype)

    return walk(tree, "")
