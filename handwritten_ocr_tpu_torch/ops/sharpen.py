"""Sharpening (port of ``handwritten_ocr_tpu/ops/sharpen.py``).

cv2.filter2D with the 5-point kernel [[0,-1,0],[-1,5,-1],[0,-1,0]] over the
default BORDER_REFLECT_101 border, saturating back to uint8. The kernel is
integer-valued, so the result is bit-exact.
"""

from __future__ import annotations

import numpy as np
import torch

from handwritten_ocr_tpu_torch.ops.filters import (conv2d_fixed,
                                                   round_half_even_u8)

_KERNEL = np.array([[0, -1, 0], [-1, 5, -1], [0, -1, 0]], dtype=np.float32)


def sharpen(image: torch.Tensor) -> torch.Tensor:
    """uint8 [H, W] or [H, W, C] → uint8, cv2.filter2D-equivalent."""
    return round_half_even_u8(conv2d_fixed(image, _KERNEL, border="reflect101"))
