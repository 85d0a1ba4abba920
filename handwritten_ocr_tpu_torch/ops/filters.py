"""Filtering primitives with OpenCV border semantics (port of
``handwritten_ocr_tpu/ops/filters.py``): separable and small dense
correlations, and rect-kernel erosion and dilation."""

from __future__ import annotations

import numpy as np
import torch


def gaussian_kernel_1d(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """cv2.getGaussianKernel for the analytic path (sigma <= 0 derives
    sigma from ksize; adaptiveThreshold's 21-tap block takes this path)."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    kernel = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    return kernel / kernel.sum()


def _border_index(n: int, lo: int, hi: int, border: str,
                  device) -> torch.Tensor:
    """Source index of each of the ``lo + n + hi`` padded positions:
    'replicate' clamps, 'reflect101' mirrors without repeating the edge
    (numpy's 'reflect'), periodically for pads wider than the image."""
    index = torch.arange(-lo, n + hi, device=device)
    if border == "replicate":
        return index.clamp(0, n - 1)
    if border != "reflect101":
        raise ValueError(f"unknown border {border!r}")
    if n == 1:
        return torch.zeros_like(index)
    period = 2 * (n - 1)
    index = index.remainder(period)
    return torch.where(index >= n, period - index, index)


def pad2d(image: torch.Tensor, pad_h: int | tuple[int, int],
          pad_w: int | tuple[int, int], border: str) -> torch.Tensor:
    """Pad the two leading axes of [H, W] or [H, W, C] with an OpenCV
    border mode ('replicate' or 'reflect101'); a pad is one width for
    both sides or (before, after). Any dtype: the pad copies pixels."""
    (top, bottom) = pad_h if isinstance(pad_h, tuple) else (pad_h, pad_h)
    (left, right) = pad_w if isinstance(pad_w, tuple) else (pad_w, pad_w)
    h, w = image.shape[:2]
    rows = _border_index(h, top, bottom, border, image.device)
    cols = _border_index(w, left, right, border, image.device)
    return image.index_select(0, rows).index_select(1, cols)


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


def box_mean(image: torch.Tensor, ksize: int,
             border: str = "replicate") -> torch.Tensor:
    """Normalized box filter (cv2 boxFilter normalize=True)."""
    return separable_filter(image, np.full(ksize, 1.0 / ksize), border)


def conv2d_fixed(image: torch.Tensor, kernel: np.ndarray,
                 border: str = "reflect101") -> torch.Tensor:
    """Small dense 2D correlation (cv2.filter2D semantics), float32 out,
    on [H, W] or [H, W, C]; the taps are summed in the JAX package's
    order, zero taps skipped."""
    kh, kw = kernel.shape
    h, w = image.shape[:2]
    x = pad2d(image.float(), kh // 2, kw // 2, border)
    out = torch.zeros(image.shape, dtype=torch.float32, device=image.device)
    for i in range(kh):
        for j in range(kw):
            weight = float(kernel[i, j])
            if weight != 0.0:
                out = out + weight * x[i:i + h, j:j + w]
    return out


def round_half_even_u8(x: torch.Tensor) -> torch.Tensor:
    """saturate_cast<uchar> of a float (cvRound = round half to even)."""
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def erode_rect(binary: torch.Tensor, kw: int, kh: int) -> torch.Tensor:
    """Rect-kernel erosion (min filter), replicate border, uint8 in/out."""
    return _rect_extremum(binary, kw, kh, torch.amin)


def dilate_rect(binary: torch.Tensor, kw: int, kh: int) -> torch.Tensor:
    """Rect-kernel dilation (max filter), replicate border, uint8 in/out."""
    return _rect_extremum(binary, kw, kh, torch.amax)


def _rect_extremum(image: torch.Tensor, kw: int, kh: int,
                   reduce) -> torch.Tensor:
    # cv2 center anchor: window [x - k//2, x + (k-1)//2] for even kernels;
    # a row pass then a column pass over sliding-window views.
    x = pad2d(image, (kh // 2, (kh - 1) // 2), (kw // 2, (kw - 1) // 2),
              "replicate")
    x = reduce(x.unfold(1, kw, 1), dim=-1)
    return reduce(x.unfold(0, kh, 1), dim=-1)
