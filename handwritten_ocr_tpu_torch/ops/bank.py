"""Transform registry and strategy-chain runner (port of ``ops/bank.py``).

Transforms apply left to right; "original" is a no-op. high_contrast and
binarize return grayscale, deskew keeps the input mode. All transforms
take and return uint8 tensors ([H, W] gray or [H, W, 3] RGB) on the
image's device.

The JAX chain skips names it does not know. The port raises
NotImplementedError for a transform the JAX package has and the port does
not yet (sharpen, denoise, remove_lines), so a chain never silently gives
another page than the reference; only a name the JAX package also lacks
is skipped.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from handwritten_ocr_tpu_torch.ops.clahe import clahe
from handwritten_ocr_tpu_torch.ops.geometry import (deskew_angle,
                                                    rotation_matrix,
                                                    warp_affine_bicubic)
from handwritten_ocr_tpu_torch.ops.gray import rgb_to_gray
from handwritten_ocr_tpu_torch.ops.threshold import adaptive_threshold_gaussian


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
    angle = deskew_angle(gray.cpu().numpy())
    if angle is None:
        return image
    h, w = gray.shape
    return warp_affine_bicubic(image, rotation_matrix((w // 2, h // 2), angle))


TRANSFORMS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "high_contrast": apply_high_contrast,
    "binarize": apply_binarize,
    "deskew": apply_deskew,
}

# Every transform name of the JAX package's registry.
REFERENCE_TRANSFORMS = frozenset({"high_contrast", "binarize", "sharpen",
                                  "deskew", "denoise", "remove_lines"})


def preprocess_chain(image: torch.Tensor,
                     strategy: str | Sequence[str]) -> torch.Tensor:
    """Apply a strategy chain left to right."""
    steps = [strategy] if isinstance(strategy, str) else list(strategy)
    out = image
    for step in steps:
        transform = TRANSFORMS.get(step)
        if transform is None:
            if step in REFERENCE_TRANSFORMS:
                raise NotImplementedError(
                    f"transform '{step}' is not ported to PyTorch yet")
            continue                       # "original" and unknown names
        out = transform(out)
    return out
