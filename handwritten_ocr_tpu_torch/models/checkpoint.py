"""The port's native checkpoint: a parameter tree on ``torch.save`` plus
``meta.json``.

Counterpart of ``handwritten_ocr_tpu/models/checkpoint.py`` (orbax there).
A checkpoint is a directory holding ``params.pt`` (the tree in the port's
layout: dicts, lists, tensors; int8 trees as they are) and ``meta.json``
(the model family and the original HF config, ``hf_config``, from which
the engines rebuild their config). ``from_pretrained`` takes such a
directory where it finds ``meta.json``, and an HF snapshot otherwise.
Loading is ``torch.load(weights_only=True)`` over a memory map, so it runs
no pickled code and reads each tensor once.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import torch

PARAMS_NAME = "params.pt"


def save_checkpoint(path: str | Path, params: Any, meta: dict) -> None:
    """Write ``params`` + ``meta`` to the directory ``path`` (created or
    overwritten); tensors are saved from the CPU."""
    path = Path(path).resolve()
    path.mkdir(parents=True, exist_ok=True)
    torch.save(_to_cpu(params), path / PARAMS_NAME)
    (path / "meta.json").write_text(json.dumps(meta, indent=2))


def load_checkpoint(path: str | Path,
                    device: str | torch.device = "cpu") -> tuple[Any, dict]:
    """(params on ``device``, meta) from a native checkpoint."""
    path = Path(path).resolve()
    meta = json.loads((path / "meta.json").read_text())
    params = torch.load(path / PARAMS_NAME, map_location="cpu",
                        weights_only=True, mmap=True)
    return _to(params, torch.device(device)), meta


def _to_cpu(tree):
    return _to(tree, torch.device("cpu"))


def _to(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to(v, device) for v in tree]
    return tree.to(device)
