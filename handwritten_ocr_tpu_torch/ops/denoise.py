"""Non-local means denoising (port of ``handwritten_ocr_tpu/ops/denoise.py``).

The strategy bank's ``denoise`` is ``cv2.fastNlMeansDenoising{Colored}``
(h=10, template 7, search 21), whose semantics the JAX package
reproduces and this port follows step for step:

- **Grayscale / per-group core** (:func:`nl_means`): weights
  ``exp(-(patch_ssd / (template^2 * channels)) / h^2)`` over the 21x21
  search window (center included), reflect-101 borders, and a
  round-half-up weighted average, in float32. The offsets run in the JAX
  scan's order and every sum in its order; only ``exp`` differs (another
  implementation), which PARITY.md's tolerance covers (gray <= 1 level).
- **Colored** (:func:`nl_means_colored`): through the LINEAR-variant
  CIELAB (``ops/colorspace.py``), L denoised alone with ``h`` and the
  (a, b) pair jointly with ``h_color``, then converted back.

One loop over the 441 search offsets; each step is a handful of
elementwise operations over the page on its device.
"""

from __future__ import annotations

import torch

from handwritten_ocr_tpu_torch.ops.filters import pad2d


def nl_means(image: torch.Tensor, h: float = 10.0, template: int = 7,
             search: int = 21) -> torch.Tensor:
    """uint8 [H, W] or [H, W, C] → uint8 denoised (joint C-channel
    distance, as cv2's multi-channel fastNlMeansDenoising)."""
    squeeze = image.dim() == 2
    img = image[..., None] if squeeze else image
    height, width, channels = img.shape
    half_search = search // 2
    half_tmpl = template // 2
    pad = half_search + half_tmpl
    padded = pad2d(img.float(), pad, pad, "reflect101")
    span_h, span_w = height + 2 * half_tmpl, width + 2 * half_tmpl
    center = padded[half_search:half_search + span_h,
                    half_search:half_search + span_w]
    dev = image.device
    # Divisions by 0-d tensors: the card's division by a Python scalar
    # multiplies by the reciprocal.
    area = torch.tensor(float(template * template * channels), device=dev)
    norm = torch.tensor(1.0 / (h * h), dtype=torch.float32, device=dev)

    acc = torch.zeros((height, width, channels), dtype=torch.float32,
                      device=dev)
    weight_sum = torch.zeros((height, width), dtype=torch.float32, device=dev)
    for dy in range(search):
        for dx in range(search):
            diff = center - padded[dy:dy + span_h, dx:dx + span_w]
            diff2 = (diff * diff).sum(dim=-1)
            # Separable box sum over the template window ('valid' crop).
            rows = sum(diff2[:, i:i + width] for i in range(template))
            dist = sum(rows[i:i + height] for i in range(template)) / area
            w = torch.exp(-dist * norm)
            neigh = padded[dy + half_tmpl:dy + half_tmpl + height,
                           dx + half_tmpl:dx + half_tmpl + width]
            acc = acc + w[..., None] * neigh
            weight_sum = weight_sum + w
    out = acc / weight_sum[..., None]
    # cv2 rounds half UP: (estimation + weights_sum/2) / weights_sum.
    out_u8 = torch.clamp(torch.floor(out + 0.5), 0, 255).to(torch.uint8)
    return out_u8[..., 0] if squeeze else out_u8


def nl_means_colored(rgb: torch.Tensor, h: float = 10.0,
                     h_color: float = 10.0, template: int = 7,
                     search: int = 21) -> torch.Tensor:
    """cv2.fastNlMeansDenoisingColored semantics: convert via the LINEAR
    Lab variant (COLOR_LBGR2Lab), denoise L alone with ``h`` and the
    (a, b) pair jointly with ``h_color``, convert back. The input passes
    through in the caller's channel order."""
    from handwritten_ocr_tpu_torch.ops.colorspace import (
        lab_u8_to_linear_bgr, linear_bgr_to_lab_u8)
    lab_u8 = linear_bgr_to_lab_u8(rgb)
    lum = nl_means(lab_u8[..., 0], h=h, template=template, search=search)
    chroma = nl_means(lab_u8[..., 1:], h=h_color, template=template,
                      search=search)
    return lab_u8_to_linear_bgr(torch.cat([lum[..., None], chroma], dim=-1))
