"""Adaptive Gaussian threshold (port of ``ops/threshold.py``).

binarize contract: cv2.adaptiveThreshold(ADAPTIVE_THRESH_GAUSSIAN_C,
THRESH_BINARY, blockSize 21, C=10) on grayscale: dst = maxval where
src > mean - C, else 0, with the mean from a rounded Gaussian blur over a
replicate border.
"""

from __future__ import annotations

import torch

from handwritten_ocr_tpu_torch.ops.filters import (gaussian_kernel_1d,
                                                   round_half_even_u8,
                                                   separable_filter)


def adaptive_threshold_gaussian(image: torch.Tensor, block_size: int = 21,
                                c: float = 10, maxval: int = 255) -> torch.Tensor:
    """uint8 [H, W] → uint8 binary (GAUSSIAN_C / THRESH_BINARY)."""
    kernel = gaussian_kernel_1d(block_size)
    mean = round_half_even_u8(separable_filter(image, kernel, "replicate"))
    delta = int(round(c))
    keep = image.to(torch.int32) > (mean.to(torch.int32) - delta)
    return torch.where(keep, maxval, 0).to(torch.uint8)
