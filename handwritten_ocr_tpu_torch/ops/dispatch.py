"""Kernel dispatch: CPU tensors take the plain version, CUDA tensors the kernel.

Replaces ``handwritten_ocr_tpu/ops/dispatch.py``. There are no modes and no
environment switches: the device of the tensors decides. A CUDA tensor
whose kernel fails to build or launch raises; nothing falls back.
"""

from __future__ import annotations

import torch


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on a CUDA device (launch the kernel),
    False when every tensor is on the CPU (run the plain version)."""
    if all(tensor.is_cuda for tensor in tensors):   # the hot path: no set
        return True
    kinds = {tensor.device.type for tensor in tensors}
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on mixed or unsupported devices: {sorted(kinds)}")


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: the caller's choice, else the
    first CUDA card. Without a card and without a choice it raises rather
    than fall back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def check(condition: bool, message: str) -> None:
    """Raise ValueError(message) unless ``condition`` holds (input checks
    of the kernel wrappers; unlike ``assert`` it survives ``python -O``)."""
    if not condition:
        raise ValueError(message)
