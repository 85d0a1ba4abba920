"""PNG files without PIL: a reader and a writer on the standard library's
``zlib``.

The card's machine has no PIL, so ``models/processor.py:load_image_rgb``
reads PNG pages here. The reader takes what page scans and PIL's own
writer produce: 8-bit grayscale, grayscale + alpha, RGB and RGBA,
non-interlaced, with any of the five row filters; every chunk's CRC is
checked. Anything else (palettes, 16-bit samples, interlacing) raises
``ValueError`` naming the feature. Sub and Up rows are undone with numpy
over the whole row; Avg and Paeth depend on the byte to their left, so
they run byte by byte.

The writer (:func:`write_png`) lets tests and ``chip_smoke.py`` make page
files on a machine without PIL; it can force each row's filter type.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Sequence

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel (8-bit only)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_NAMES = {3: "palette (colour type 3)"}


def _chunks(data: bytes):
    """(type, payload) of every chunk, CRC checked."""
    pos = len(SIGNATURE)
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("PNG: truncated chunk header")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"PNG: truncated {kind!r} chunk")
        payload = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(kind + payload) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG: CRC mismatch in the {kind!r} chunk")
        yield kind, payload
        pos = end + 4
        if kind == b"IEND":
            return
    raise ValueError("PNG: no IEND chunk")


def _unfilter_avg(row: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(bpp):
        row[i] = (row[i] + (prior[i] >> 1)) & 0xFF
    for i in range(bpp, len(row)):
        row[i] = (row[i] + ((row[i - bpp] + prior[i]) >> 1)) & 0xFF


def _unfilter_paeth(row: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(bpp):
        row[i] = (row[i] + prior[i]) & 0xFF
    for i in range(bpp, len(row)):
        a, b, c = row[i - bpp], prior[i], prior[i - bpp]
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        row[i] = (row[i] + pred) & 0xFF


def _unfilter(raw: bytes, height: int, width: int, bpp: int) -> np.ndarray:
    stride = width * bpp
    if len(raw) != height * (stride + 1):
        raise ValueError(f"PNG: image data holds {len(raw)} bytes, "
                         f"expected {height * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    kinds = rows[:, 0]
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind = int(kinds[y])
        line = rows[y, 1:]
        if kind == 0:
            out[y] = line
        elif kind == 1:             # Sub: a running sum per channel, mod 256
            out[y] = np.cumsum(line.reshape(width, bpp), axis=0,
                               dtype=np.uint8).reshape(stride)
        elif kind == 2:             # Up
            out[y] = line + prior
        elif kind in (3, 4):
            row = bytearray(line.tobytes())
            (_unfilter_avg if kind == 3 else _unfilter_paeth)(
                row, prior.tobytes(), bpp)
            out[y] = np.frombuffer(bytes(row), np.uint8)
        else:
            raise ValueError(f"PNG: unknown row filter type {kind}")
        prior = out[y]
    return out


def read_png(source: str | Path | bytes) -> np.ndarray:
    """uint8 ``[H, W, C]`` samples of a PNG (C = 1 gray, 2 gray + alpha,
    3 RGB, 4 RGBA)."""
    data = source if isinstance(source, bytes) else Path(source).read_bytes()
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file (bad signature)")
    header, idat = None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    width, height, depth, color, compression, filter_method, interlace = header
    if color not in _CHANNELS:
        raise ValueError("PNG: unsupported colour type "
                         + _COLOR_NAMES.get(color, str(color)))
    if depth != 8:
        raise ValueError(f"PNG: unsupported bit depth {depth} (8-bit only)")
    if interlace != 0:
        raise ValueError("PNG: unsupported interlacing (Adam7)")
    if compression != 0 or filter_method != 0:
        raise ValueError("PNG: unknown compression or filter method")
    bpp = _CHANNELS[color]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), height, width, bpp)
    return pixels.reshape(height, width, bpp)


def to_rgb(samples: np.ndarray) -> np.ndarray:
    """``[H, W, 3]`` RGB of PNG samples, as PIL's ``convert("RGB")``: gray
    is repeated, alpha dropped."""
    channels = samples.shape[-1]
    if channels in (1, 2):
        return np.repeat(samples[..., :1], 3, axis=-1)
    return np.ascontiguousarray(samples[..., :3])


def _chunk(kind: bytes, payload: bytes) -> bytes:
    crc = zlib.crc32(kind + payload) & 0xFFFFFFFF
    return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", crc)


def _filter_row(line: np.ndarray, prior: np.ndarray, bpp: int,
                kind: int) -> np.ndarray:
    cur = line.astype(np.int16)
    up = prior.astype(np.int16)
    left = np.concatenate([np.zeros(bpp, np.int16), cur[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int16), up[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(cur)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = up
    elif kind == 3:
        pred = (left + up) >> 1
    elif kind == 4:
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, upleft))
    else:
        raise ValueError(f"unknown row filter type {kind}")
    return ((cur - pred) & 0xFF).astype(np.uint8)


def write_png(path: str | Path, image: np.ndarray,
              filters: Sequence[int] | int = 2) -> None:
    """Write uint8 ``[H, W]`` or ``[H, W, C]`` (C in 1-4) as an 8-bit,
    non-interlaced PNG; ``filters`` is one row filter type (0-4) for every
    row, or one per row."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError("write_png takes uint8 samples")
    if image.ndim == 2:
        image = image[..., None]
    height, width, channels = image.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    kinds = [filters] * height if isinstance(filters, int) else list(filters)
    rows = image.reshape(height, width * channels)
    prior = np.zeros(width * channels, np.uint8)
    raw = bytearray()
    for y in range(height):
        raw.append(kinds[y])
        raw += _filter_row(rows[y], prior, channels, kinds[y]).tobytes()
        prior = rows[y]
    header = struct.pack(">IIBBBBB", width, height, 8, color, 0, 0, 0)
    Path(path).write_bytes(SIGNATURE + _chunk(b"IHDR", header)
                           + _chunk(b"IDAT", zlib.compress(bytes(raw), 6))
                           + _chunk(b"IEND", b""))
