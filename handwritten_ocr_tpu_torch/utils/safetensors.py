"""The safetensors format without the ``safetensors`` package.

A file is an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` plus an
optional ``"__metadata__"``), then the raw little-endian tensors, their
offsets counted from the end of the header. A sharded snapshot adds
``model.safetensors.index.json`` (``{"weight_map": {name: file}}``).

:func:`load_file` maps the file copy-on-write (``mmap``), so a tensor's
bytes are read from disk only when something touches them, and a 65 GB
snapshot converted tensor by tensor is never held twice. bf16 tensors
are the file's 16-bit words viewed as ``torch.bfloat16``, not a round
trip through fp32. :func:`save_file` writes the same format (tests and
``chip_smoke.py`` make snapshots with it).
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path
from typing import Mapping

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {dtype: name for name, dtype in DTYPES.items()}
INDEX_NAME = "model.safetensors.index.json"


def read_header(path: str | Path) -> tuple[dict, int]:
    """(the JSON header, the byte offset where tensor data starts)."""
    with open(path, "rb") as f:
        (length,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(length))
    return header, 8 + length


def load_file(path: str | Path) -> dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, as CPU tensors over a
    copy-on-write map of the file (writing to one never touches disk)."""
    header, start = read_header(path)
    header.pop("__metadata__", None)
    if not header:
        return {}
    with open(path, "rb") as f:
        mapped = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    out = {}
    for name, info in header.items():
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype "
                             f"{info['dtype']}")
        dtype = DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        raw = torch.frombuffer(mapped, dtype=torch.uint8, count=end - begin,
                               offset=start + begin) if end > begin else \
            torch.empty(0, dtype=torch.uint8)
        if (start + begin) % dtype.itemsize:      # unaligned: copy it out
            raw = raw.clone()
        tensor = raw.view(dtype).reshape(shape)
        if tensor.numel() * dtype.itemsize != end - begin:
            raise ValueError(f"{path}: tensor {name} holds {end - begin} "
                             f"bytes, not {shape} of {info['dtype']}")
        out[name] = tensor
    return out


def shard_files(source: str | Path) -> list[Path]:
    """The ``.safetensors`` files of a snapshot: a file, a directory (the
    shards its index names, else every ``*.safetensors`` in it), or an
    index file."""
    source = Path(source)
    if source.is_file() and source.name.endswith(".index.json"):
        index, root = source, source.parent
    elif source.is_dir():
        index, root = source / INDEX_NAME, source
        if not index.exists():
            shards = sorted(source.glob("*.safetensors"))
            if not shards:
                raise FileNotFoundError(f"no .safetensors files under {source}")
            return shards
    else:
        return [source]
    weight_map = json.loads(index.read_text())["weight_map"]
    return [root / name for name in sorted(set(weight_map.values()))]


def load_snapshot(source: str | Path) -> dict[str, torch.Tensor]:
    """Every tensor of a snapshot (see :func:`shard_files`), mapped."""
    flat: dict[str, torch.Tensor] = {}
    for shard in shard_files(source):
        flat.update(load_file(shard))
    return flat


def save_file(tensors: Mapping[str, torch.Tensor], path: str | Path,
              metadata: dict[str, str] | None = None) -> None:
    """Write ``tensors`` (any device; written from the CPU) as one file,
    largest element size first so every tensor is aligned."""
    items = sorted(tensors.items(),
                   key=lambda kv: (-kv[1].element_size(), kv[0]))
    header: dict = {"__metadata__": metadata} if metadata else {}
    blobs, offset = [], 0
    for name, tensor in items:
        data = tensor.detach().to("cpu").contiguous()
        raw = data.view(torch.uint8).numpy().tobytes() if data.numel() else b""
        header[name] = {"dtype": _NAMES[data.dtype], "shape": list(data.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-(8 + len(text)) % 8)          # data starts 8-aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in blobs:
            f.write(raw)


def save_sharded(tensors: Mapping[str, torch.Tensor], directory: str | Path,
                 shards: int, prefix: str = "model") -> None:
    """Write ``tensors`` as ``shards`` files plus the index, as HF
    snapshots are laid out (names split in order, round robin free)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    names = list(tensors)
    per = -(-len(names) // shards)
    weight_map = {}
    for i in range(shards):
        chunk = names[i * per:(i + 1) * per]
        filename = f"{prefix}-{i + 1:05d}-of-{shards:05d}.safetensors"
        save_file({name: tensors[name] for name in chunk}, directory / filename)
        weight_map.update({name: filename for name in chunk})
    total = sum(t.numel() * t.element_size() for t in tensors.values())
    (directory / INDEX_NAME).write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map},
        indent=2))
