"""Transform registry and strategy-chain runner (port of ``ops/bank.py``).

Transforms apply left to right; "original" is a no-op and unknown names
are skipped, as in the JAX package. high_contrast and binarize return
grayscale, deskew / denoise / remove_lines keep the input mode, sharpen
filters whatever it is given. All transforms take and return uint8
tensors ([H, W] gray or [H, W, 3] RGB) on the image's device. The
registry has every transform of the JAX package's.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from handwritten_ocr_tpu_torch.ops.clahe import clahe
from handwritten_ocr_tpu_torch.ops.denoise import nl_means, nl_means_colored
from handwritten_ocr_tpu_torch.ops.geometry import (deskew_angle,
                                                    rotation_matrix,
                                                    warp_affine_bicubic)
from handwritten_ocr_tpu_torch.ops.gray import rgb_to_gray
from handwritten_ocr_tpu_torch.ops.lines import remove_lines
from handwritten_ocr_tpu_torch.ops.sharpen import sharpen
from handwritten_ocr_tpu_torch.ops.threshold import adaptive_threshold_gaussian
from handwritten_ocr_tpu_torch.trace import profile_span


def apply_high_contrast(image: torch.Tensor) -> torch.Tensor:
    """CLAHE clip 3.0, 8x8 tiles on grayscale."""
    return clahe(rgb_to_gray(image))


def apply_binarize(image: torch.Tensor) -> torch.Tensor:
    """Adaptive Gaussian threshold, block 21, C=10."""
    return adaptive_threshold_gaussian(rgb_to_gray(image))


def apply_deskew(image: torch.Tensor) -> torch.Tensor:
    """Rotate by the min-area-rect angle of the dark pixels.

    The angle search runs on the host (its input size depends on the
    data); the bicubic warp runs on the image's device. Images with
    <= 100 dark pixels pass through."""
    gray = rgb_to_gray(image)
    pixels = gray.cpu().numpy()
    with profile_span("preprocess.deskew_angle"):
        angle = deskew_angle(pixels)
    if angle is None:
        return image
    h, w = gray.shape
    return warp_affine_bicubic(image, rotation_matrix((w // 2, h // 2), angle))


def apply_denoise(image: torch.Tensor) -> torch.Tensor:
    """Non-local means, h=10, template 7, search 21: RGB goes through the
    CIELAB L/ab split (fastNlMeansDenoisingColored), grayscale through the
    single-plane variant (fastNlMeansDenoising)."""
    return nl_means_colored(image) if image.dim() == 3 else nl_means(image)


TRANSFORMS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "high_contrast": apply_high_contrast,
    "binarize": apply_binarize,
    "sharpen": sharpen,
    "deskew": apply_deskew,
    "denoise": apply_denoise,
    "remove_lines": remove_lines,
}


def preprocess_chain(image: torch.Tensor,
                     strategy: str | Sequence[str]) -> torch.Tensor:
    """Apply a strategy chain left to right; "original" and names not in
    the registry are skipped."""
    steps = [strategy] if isinstance(strategy, str) else list(strategy)
    out = image
    for step in steps:
        transform = TRANSFORMS.get(step)
        if transform is not None:
            out = transform(out)
    return out
