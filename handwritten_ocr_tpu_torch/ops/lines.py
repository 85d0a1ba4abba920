"""Ruled-line removal (port of ``handwritten_ocr_tpu/ops/lines.py``).

Detect horizontal lines in the inverted grayscale with a mean-adaptive
threshold (block 15, C=-2), a morphological opening with a (W/4, 1)
kernel, a (1, 3) dilation to cover the full line thickness, and inpaint
the masked pixels. The JAX package inpaints by masked diffusion (a
vertical nearest-valid fill, then fixed Jacobi sweeps) in place of cv2's
sequential TELEA; this port runs the same steps in the same order.
"""

from __future__ import annotations

import torch

from handwritten_ocr_tpu_torch.ops.filters import dilate_rect, erode_rect
from handwritten_ocr_tpu_torch.ops.gray import rgb_to_gray
from handwritten_ocr_tpu_torch.ops.threshold import adaptive_threshold_mean


def line_mask(gray: torch.Tensor) -> torch.Tensor:
    """uint8 [H, W] grayscale → uint8 {0,255} horizontal-line mask."""
    thresh = adaptive_threshold_mean(255 - gray, block_size=15, c=-2)
    kernel_w = max(gray.shape[1] // 4, 1)
    opened = dilate_rect(erode_rect(thresh, kernel_w, 1), kernel_w, 1)
    return dilate_rect(opened, 1, 3)


def inpaint_diffusion(image: torch.Tensor, mask: torch.Tensor,
                      iterations: int = 64) -> torch.Tensor:
    """Fill masked pixels by diffusion from unmasked neighbors.

    image uint8 [H, W] or [H, W, C]; mask uint8/bool [H, W] (nonzero =
    inpaint)."""
    squeeze = image.dim() == 2
    img = image[..., None] if squeeze else image
    hole = (mask > 0)[..., None]
    img_f = img.float()
    zero = torch.zeros((), dtype=torch.float32, device=image.device)
    floor = torch.tensor(1e-6, dtype=torch.float32, device=image.device)
    # Initial estimate: the nearest valid pixels above and below, spread
    # by 16 short propagation steps (vertical fill suits line holes).
    values = torch.where(hole, zero, img_f)
    weight = (~hole).float()
    for _ in range(16):
        up_v, down_v = torch.roll(values, 1, 0), torch.roll(values, -1, 0)
        up_w, down_w = torch.roll(weight, 1, 0), torch.roll(weight, -1, 0)
        new_w = torch.maximum(weight, torch.maximum(up_w, down_w) * 0.5)
        summed = values * weight + up_v * up_w + down_v * down_w
        total = weight + up_w + down_w
        new_v = torch.where(total > 0, summed / torch.maximum(total, floor),
                            values)
        values = torch.where(weight > 0, values, new_v)
        weight = new_w
    out = torch.where(hole, values, img_f)
    for _ in range(iterations):
        neighbors = (torch.roll(out, 1, 0) + torch.roll(out, -1, 0)
                     + torch.roll(out, 1, 1) + torch.roll(out, -1, 1)) * 0.25
        out = torch.where(hole, neighbors, img_f)
    out_u8 = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    return out_u8[..., 0] if squeeze else out_u8


def remove_lines(image: torch.Tensor) -> torch.Tensor:
    """Full remove_lines transform on uint8 [H, W] or [H, W, 3]."""
    return inpaint_diffusion(image, line_mask(rgb_to_gray(image)))
