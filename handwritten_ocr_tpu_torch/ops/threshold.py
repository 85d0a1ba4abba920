"""Adaptive thresholding (port of ``ops/threshold.py``).

Contracts (cv2.adaptiveThreshold, THRESH_BINARY): binarize is
GAUSSIAN_C, blockSize 21, C=10 on grayscale; the remove_lines mask is
MEAN_C, blockSize 15, C=-2 on the inverted grayscale. dst = maxval where
src > mean - C, else 0, with the mean from a rounded Gaussian or box blur
over a replicate border.
"""

from __future__ import annotations

import torch

from handwritten_ocr_tpu_torch.ops.filters import (box_mean,
                                                   gaussian_kernel_1d,
                                                   round_half_even_u8,
                                                   separable_filter)


def adaptive_threshold_gaussian(image: torch.Tensor, block_size: int = 21,
                                c: float = 10, maxval: int = 255) -> torch.Tensor:
    """uint8 [H, W] → uint8 binary (GAUSSIAN_C / THRESH_BINARY)."""
    kernel = gaussian_kernel_1d(block_size)
    mean = round_half_even_u8(separable_filter(image, kernel, "replicate"))
    return _binary(image, mean, c, maxval)


def adaptive_threshold_mean(image: torch.Tensor, block_size: int = 15,
                            c: float = -2, maxval: int = 255) -> torch.Tensor:
    """uint8 [H, W] → uint8 binary (MEAN_C / THRESH_BINARY)."""
    mean = round_half_even_u8(box_mean(image, block_size, "replicate"))
    return _binary(image, mean, c, maxval)


def _binary(src: torch.Tensor, mean: torch.Tensor, c: float,
            maxval: int) -> torch.Tensor:
    delta = int(round(c))
    keep = src.to(torch.int32) > (mean.to(torch.int32) - delta)
    return torch.where(keep, maxval, 0).to(torch.uint8)
