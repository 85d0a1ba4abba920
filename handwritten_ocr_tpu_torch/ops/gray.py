"""Grayscale conversion matching cv2.cvtColor(RGB2GRAY) bit-exactly.

Port of ``handwritten_ocr_tpu/ops/gray.py``: Y in Q15 fixed point with the
blue coefficient adjusted so the three sum to exactly 2^15, rounding by
+2^14 then >> 15.
"""

from __future__ import annotations

import torch

_R, _G = 9798, 19235
_B = (1 << 15) - _R - _G
_HALF = 1 << 14


def rgb_to_gray(image: torch.Tensor) -> torch.Tensor:
    """uint8 [H, W, 3] RGB → uint8 [H, W]; a [H, W] image passes through."""
    if image.dim() == 2:
        return image
    rgb = image.to(torch.int32)
    y = (_R * rgb[..., 0] + _G * rgb[..., 1] + _B * rgb[..., 2] + _HALF) >> 15
    return y.to(torch.uint8)
