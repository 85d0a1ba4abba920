"""Separable filtering with OpenCV border semantics (the parts of
``handwritten_ocr_tpu/ops/filters.py`` that the threshold uses)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel_1d(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """cv2.getGaussianKernel for the analytic path (sigma <= 0 derives
    sigma from ksize; adaptiveThreshold's 21-tap block takes this path)."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    kernel = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    return kernel / kernel.sum()


def pad2d(image: torch.Tensor, pad_h: int, pad_w: int,
          border: str) -> torch.Tensor:
    """Pad a float [H, W] image: 'replicate' or 'reflect101' (OpenCV names)."""
    mode = {"replicate": "replicate", "reflect101": "reflect"}[border]
    return F.pad(image[None, None], (pad_w, pad_w, pad_h, pad_h),
                 mode=mode)[0, 0]


def separable_filter(image: torch.Tensor, kernel_1d: np.ndarray,
                     border: str = "replicate") -> torch.Tensor:
    """2D filter with a separable kernel; float32 output, [H, W] input.

    Row pass then column pass, each summed tap by tap in the JAX
    package's order, so the float32 sums match it."""
    taps = [float(np.float32(w)) for w in kernel_1d]
    pad = len(taps) // 2
    h, w = image.shape
    x = pad2d(image.float(), pad, pad, border)
    x = sum(x[:, i:i + w] * taps[i] for i in range(len(taps)))
    x = sum(x[i:i + h] * taps[i] for i in range(len(taps)))
    return x


def round_half_even_u8(x: torch.Tensor) -> torch.Tensor:
    """saturate_cast<uchar> of a float (cvRound = round half to even)."""
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)
