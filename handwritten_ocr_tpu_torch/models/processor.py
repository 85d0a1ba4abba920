"""VLM input processing: page files, smart resize, patch packing, chat
template.

Port of ``handwritten_ocr_tpu/models/processor.py``. It replicates the
Qwen2-VL processor contract (the olmOCR-2 processor): dimensions rounded
to multiples of patch·merge (28), PIL's bicubic resample, CLIP
normalisation, cell-major patch packing, the Qwen2-VL chat template.

Nothing here needs PIL: PNG pages load through ``models/png.py`` and the
resize reproduces PIL's fixed-point bicubic in int64 tensor ops, bit-equal
on the CPU and on the card. Other image formats load through PIL where it
is installed, and raise naming it where it is not.
"""

from __future__ import annotations

import dataclasses
import io
import math
import re
from pathlib import Path
from typing import Protocol, Sequence, runtime_checkable

import numpy as np
import torch

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)

IM_START, IM_END = "<|im_start|>", "<|im_end|>"
VISION_START, VISION_END = "<|vision_start|>", "<|vision_end|>"
IMAGE_PAD = "<|image_pad|>"
DEFAULT_SYSTEM = "You are a helpful assistant."


def smart_resize(height: int, width: int, factor: int = 28,
                 min_pixels: int = 256 * 256,
                 max_pixels: int = 1024 * 1024) -> tuple[int, int]:
    """Target (h, w): factor-aligned, aspect-preserving, pixel-clamped."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError("absolute aspect ratio must be smaller than 200")
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def aligned_smart_size(height: int, width: int, factor: int = 28,
                       min_pixels: int = 256 * 256,
                       max_pixels: int = 1024 * 1024) -> tuple[int, int]:
    """smart_resize target, used for load-time resizing."""
    return smart_resize(height, width, factor, min_pixels, max_pixels)


@dataclasses.dataclass(frozen=True)
class PackedImage:
    patches: np.ndarray               # [S, C*T*ps*ps] float32
    grid: tuple[int, int, int]        # (t, h, w) patch grid

    @property
    def num_llm_tokens(self) -> int:
        t, h, w = self.grid
        return t * h * w // 4          # spatial merge 2x2


def load_image_rgb(path: str | Path) -> np.ndarray:
    """uint8 [H, W, 3] RGB from an image file: PNG through the port's own
    reader (``models/png.py``), any other format through PIL, which must
    then be installed."""
    from handwritten_ocr_tpu_torch.models import png
    data = Path(path).read_bytes()
    if data.startswith(png.SIGNATURE):
        return png.to_rgb(png.read_png(data))
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(f"{path}: not a PNG file, and PIL, which reads the "
                         "other formats, is not installed; only PNG pages "
                         "load without PIL") from None
    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("RGB"))


# PIL's resample (libImaging/Resample.c): filter coefficients in double,
# normalised, then fixed point with PRECISION_BITS fractional bits; each
# pass accumulates in integers from one half and clips to uint8.
_PRECISION_BITS = 32 - 8 - 2


def _bicubic_filter(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near, far = x < 1.0, (x >= 1.0) & (x < 2.0)
    out = np.zeros_like(x)
    out[near] = ((a + 2.0) * x[near] - (a + 3.0)) * x[near] * x[near] + 1
    out[far] = (((x[far] - 5) * x[far] + 8) * x[far] - 4) * a
    return out


def _resample_coeffs(in_size: int, out_size: int):
    """(source index [out, k], fixed-point weight [out, k]) of one axis,
    as PIL's ``precompute_coeffs`` + ``normalize_coeffs_8bpc``; unused
    taps point at index 0 with weight 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale                     # bicubic support 2
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    count = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                       in_size) - xmin
    taps = np.arange(ksize)
    weights = np.zeros((out_size, ksize))
    total = np.zeros(out_size)
    for x in taps:                     # PIL's summation order
        w = np.where(x < count, _bicubic_filter(
            (x + xmin - center + 0.5) / filterscale), 0.0)
        weights[:, x] = w
        total = total + w
    nonzero = total != 0.0
    weights[nonzero] /= total[nonzero, None]
    scaled = weights * (1 << _PRECISION_BITS)
    fixed = np.where(weights < 0, np.trunc(-0.5 + scaled),
                     np.trunc(0.5 + scaled)).astype(np.int64)
    used = taps[None] < count[:, None]
    index = np.where(used, xmin[:, None] + taps[None], 0)
    return index, np.where(used, fixed, 0)


def _resample_axis(pixels: torch.Tensor, axis: int,
                   out_size: int) -> torch.Tensor:
    """One pass of PIL's resample along ``axis`` (0 rows, 1 columns) of
    int64 [H, W, C] samples; exact integer arithmetic on any device."""
    index, fixed = _resample_coeffs(pixels.shape[axis], out_size)
    index = torch.as_tensor(index, device=pixels.device)
    fixed = torch.as_tensor(fixed, device=pixels.device)
    shape = (-1, 1, 1) if axis == 0 else (1, -1, 1)
    acc = torch.full((1, 1, 1), 1 << (_PRECISION_BITS - 1),
                     dtype=torch.int64, device=pixels.device)
    for tap in range(index.shape[1]):
        acc = acc + (pixels.index_select(axis, index[:, tap])
                     * fixed[:, tap].view(shape))
    return torch.clamp(acc >> _PRECISION_BITS, 0, 255)


def resize_bicubic(image, size: tuple[int, int]):
    """PIL bicubic resize of ``image`` to (h, w), bit-equal to
    ``Image.resize((w, h), Image.BICUBIC)`` on an RGB image (the HF
    processor's resample). ``image``: uint8 [H, W] or [H, W, 3], a numpy
    array (returns one) or a tensor (returns one on its device). A
    horizontal pass then a vertical one, each skipped when its size does
    not change, as PIL does."""
    h, w = size
    as_numpy = not isinstance(image, torch.Tensor)
    pixels = torch.as_tensor(np.asarray(image)) if as_numpy else image
    if pixels.dtype != torch.uint8:
        pixels = pixels.clamp(0, 255).to(torch.uint8)
    if pixels.dim() == 2:
        pixels = torch.stack([pixels] * 3, dim=-1)
    if pixels.dim() != 3 or pixels.shape[-1] != 3:
        raise ValueError(f"resize_bicubic takes [H, W] or [H, W, 3] images, "
                         f"not {tuple(pixels.shape)}")
    out = pixels.long()
    if out.shape[1] != w:
        out = _resample_axis(out, 1, w)
    if out.shape[0] != h:
        out = _resample_axis(out, 0, h)
    out = out.to(torch.uint8)
    return out.numpy() if as_numpy else out


def pack_image(
    image: np.ndarray,
    *,
    patch_size: int = 14,
    merge_size: int = 2,
    temporal_patch_size: int = 2,
    min_pixels: int = 256 * 256,
    max_pixels: int = 1024 * 1024,
    do_resize: bool = True,
) -> PackedImage:
    """uint8/float [H, W(, C)] image → normalised flattened patches, on the
    host (numpy).

    Follows the HF Qwen2VLImageProcessor pipeline: smart-resize, rescale to
    [0, 1], CLIP-normalise, duplicate the frame to the temporal patch size,
    and pack cell-major.
    """
    if image.ndim == 2:
        image = np.stack([image] * 3, axis=-1)
    height, width = image.shape[:2]
    factor = patch_size * merge_size
    if do_resize:
        target_h, target_w = smart_resize(height, width, factor,
                                          min_pixels, max_pixels)
        if (target_h, target_w) != (height, width):
            image = resize_bicubic(image, (target_h, target_w))
        height, width = target_h, target_w
    elif height % factor or width % factor:
        raise ValueError(f"image {height}x{width} not {factor}-aligned")

    pixels = image.astype(np.float32) / 255.0
    pixels = (pixels - CLIP_MEAN) / CLIP_STD
    chw = pixels.transpose(2, 0, 1)                       # [C, H, W]
    frames = np.broadcast_to(chw, (temporal_patch_size, *chw.shape))

    channels = chw.shape[0]
    grid_t = 1
    grid_h, grid_w = height // patch_size, width // patch_size
    ps, merge = patch_size, merge_size
    packed = frames.reshape(
        grid_t, temporal_patch_size, channels,
        grid_h // merge, merge, ps,
        grid_w // merge, merge, ps,
    )
    # HF transpose order: (t, h_cell, w_cell, mh, mw, C, T, ps_h, ps_w)
    packed = packed.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    patches = packed.reshape(grid_t * grid_h * grid_w,
                             channels * temporal_patch_size * ps * ps)
    return PackedImage(patches=np.ascontiguousarray(patches),
                       grid=(grid_t, grid_h, grid_w))


def pack_image_device(image: torch.Tensor, *, patch_size: int = 14,
                      merge_size: int = 2, temporal_patch_size: int = 2):
    """Patch packing on the image's device: normalise + patchify, no resize.

    ``image``: uint8 [H, W] or [H, W, 3] with H and W multiples of
    patch·merge (28). Returns (patches [S, C·T·ps·ps] float32, grid).
    """
    if image.dim() == 2:
        image = torch.stack([image] * 3, dim=-1)
    height, width = image.shape[:2]
    factor = patch_size * merge_size
    if height % factor or width % factor:
        raise ValueError(f"image {height}x{width} not {factor}-aligned")
    mean = torch.as_tensor(CLIP_MEAN, device=image.device)
    std = torch.as_tensor(CLIP_STD, device=image.device)
    pixels = image.float() / 255.0
    pixels = (pixels - mean) / std
    chw = pixels.permute(2, 0, 1)
    frames = chw.expand(temporal_patch_size, *chw.shape)
    grid_h, grid_w = height // patch_size, width // patch_size
    ps, merge = patch_size, merge_size
    packed = frames.reshape(
        1, temporal_patch_size, 3,
        grid_h // merge, merge, ps,
        grid_w // merge, merge, ps,
    ).permute(0, 3, 6, 4, 7, 2, 1, 5, 8)
    patches = packed.reshape(grid_h * grid_w, 3 * temporal_patch_size * ps * ps)
    return patches, (1, grid_h, grid_w)


# ── tokenizer protocol + chat template ──────────────────────────────

@runtime_checkable
class TextTokenizer(Protocol):
    """Minimal tokenizer surface the engines need."""

    def encode(self, text: str) -> list[int]: ...
    def decode(self, ids: Sequence[int]) -> str: ...


class ByteTokenizer:
    """Model-free tokenizer: chars → byte ids, ``<|...|>`` specials → the
    real Qwen special ids. Lets a read run without tokenizer files while
    the prompt keeps its real structure."""

    SPECIALS = {
        IM_START: 151644, IM_END: 151645,
        VISION_START: 151652, VISION_END: 151653, IMAGE_PAD: 151655,
        "<think>": 151667, "</think>": 151668,
    }

    def __init__(self) -> None:
        self._pattern = re.compile(
            "|".join(re.escape(s) for s in self.SPECIALS))

    def encode(self, text: str) -> list[int]:
        out: list[int] = []
        pos = 0
        for match in self._pattern.finditer(text):
            out.extend(min(ord(c), 255) for c in text[pos:match.start()])
            out.append(self.SPECIALS[match.group()])
            pos = match.end()
        out.extend(min(ord(c), 255) for c in text[pos:])
        return out

    def decode(self, ids) -> str:
        return "".join(chr(i) for i in ids if i < 256)


def vlm_chat_prompt(user_text: str, num_image_tokens: int,
                    system: str = DEFAULT_SYSTEM) -> str:
    """Qwen2-VL chat-template prompt with one image before the user text."""
    vision = f"{VISION_START}{IMAGE_PAD * num_image_tokens}{VISION_END}"
    return (
        f"{IM_START}system\n{system}{IM_END}\n"
        f"{IM_START}user\n{vision}{user_text}{IM_END}\n"
        f"{IM_START}assistant\n"
    )


def llm_chat_prompt(system: str, user_text: str,
                    enable_thinking: bool = False) -> str:
    """Qwen3 chat-template prompt (non-thinking mode appends an empty
    think block)."""
    parts = []
    if system:
        parts.append(f"{IM_START}system\n{system}{IM_END}\n")
    parts.append(f"{IM_START}user\n{user_text}{IM_END}\n")
    parts.append(f"{IM_START}assistant\n")
    if not enable_thinking:
        parts.append("<think>\n\n</think>\n\n")
    return "".join(parts)
