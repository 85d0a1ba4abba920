"""cv2's 8-bit linear-BGR <-> CIELAB conversions (LBGR2Lab / Lab2LBGR);
port of ``handwritten_ocr_tpu/ops/colorspace.py``.

``cv2.fastNlMeansDenoisingColored`` detours through CIELAB using the
LINEAR variant ``COLOR_LBGR2Lab`` (no sRGB gamma decompanding):

- Forward (:func:`linear_bgr_to_lab_u8`) is OpenCV's fixed-point
  ``RGB2Lab_b`` path: 12-bit whitepoint-scaled XYZ coefficients, a
  3072-entry cube-root table built in float32, and round-half-up
  descales; integer arithmetic, bit-equal to the JAX package's.
- Backward (:func:`lab_u8_to_linear_bgr`) is the float path
  (``Lab2RGBfloat`` semantics) in float32, each operation on its own
  (no fused multiply-add), divisions by 0-d tensors (the card's division
  by a Python scalar multiplies by the reciprocal).

Channel order: index 0 plays cv2's "B" role; callers pass an RGB array
through unchanged, as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch

_LAB_SHIFT = 12          # xyz matrix fixed-point bits (OpenCV lab_shift)
_GAMMA_SHIFT = 3         # channel pre-scale bits (linear "gamma" table)
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT

# sRGB -> XYZ (D65) and inverse, OpenCV constants.
_XYZ = np.array([[0.412453, 0.357580, 0.180423],
                 [0.212671, 0.715160, 0.072169],
                 [0.019334, 0.119193, 0.950227]])
_XYZ_INV = np.array([[3.240479, -1.537150, -0.498535],
                     [-0.969256, 1.875992, 0.041556],
                     [0.055648, -0.204043, 1.057311]])
_WHITE = np.array([0.950456, 1.0, 1.088754])

# Whitepoint-scaled integer coefficients, rows X/Y/Z by columns R/G/B.
_COEFFS = np.round(_XYZ / _WHITE[:, None] * (1 << _LAB_SHIFT)).astype(np.int32)


def _build_cbrt_tab() -> np.ndarray:
    """OpenCV's LabCbrtTab_b, reproduced in float32."""
    scale = np.float32(1.0) / np.float32(1 << _GAMMA_SHIFT)
    i = np.arange(3072, dtype=np.float32)
    x = (i * scale / np.float32(255)).astype(np.float32)
    small = x * np.float32(7.787) + np.float32(0.13793103448275862)
    big = np.cbrt(x).astype(np.float32)
    value = np.where(x < np.float32(0.008856), small, big).astype(np.float32)
    return np.round((np.float32(1 << _LAB_SHIFT2) * value)
                    .astype(np.float64)).astype(np.int32)


_CBRT_TAB = _build_cbrt_tab()
_L_SCALE = (116 * 255 + 50) // 100
_L_SHIFT = -((16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100)


def _descale(value: torch.Tensor, bits: int) -> torch.Tensor:
    return (value + (1 << (bits - 1))) >> bits


def linear_bgr_to_lab_u8(img_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [H, W, 3] (channel 0 = cv2's "B") -> uint8 [H, W, 3] Lab,
    cv2.cvtColor(..., COLOR_LBGR2Lab) for 8U."""
    tab = torch.as_tensor(_CBRT_TAB, device=img_u8.device).long()
    c = _COEFFS
    b, g, r = (img_u8[..., i].to(torch.int64) << _GAMMA_SHIFT
               for i in range(3))

    def cube_root(row: int) -> torch.Tensor:
        xyz = _descale(r * int(c[row, 0]) + g * int(c[row, 1])
                       + b * int(c[row, 2]), _LAB_SHIFT)
        return tab[xyz.clamp(0, 3071)]

    fx, fy, fz = cube_root(0), cube_root(1), cube_root(2)
    lum = _descale(_L_SCALE * fy + _L_SHIFT, _LAB_SHIFT2)
    a = _descale(500 * (fx - fy) + (128 << _LAB_SHIFT2), _LAB_SHIFT2)
    bb = _descale(200 * (fy - fz) + (128 << _LAB_SHIFT2), _LAB_SHIFT2)
    return torch.stack([lum, a, bb], dim=-1).clamp(0, 255).to(torch.uint8)


def lab_u8_to_linear_bgr(lab_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [H, W, 3] Lab -> uint8 [H, W, 3] linear BGR-ordered values
    (float Lab2RGBfloat semantics, no gamma recompanding)."""
    dev = lab_u8.device

    def f32(value: float) -> torch.Tensor:
        return torch.tensor(np.float32(value), device=dev)

    lum = lab_u8[..., 0].float() * f32(100.0 / 255.0)
    a = lab_u8[..., 1].float() - f32(128.0)
    b = lab_u8[..., 2].float() - f32(128.0)
    l_thresh = np.float32(0.008856) * np.float32(903.3)
    f_thresh = (np.float32(7.787) * np.float32(0.008856)
                + np.float32(16.0 / 116.0))
    low = lum <= f32(l_thresh)
    scaled = (lum + f32(16.0)) / f32(116.0)
    y = torch.where(low, lum / f32(903.3), scaled * scaled * scaled)
    fy = torch.where(low, f32(7.787) * (lum / f32(903.3)) + f32(16.0 / 116.0),
                     scaled)
    fx = fy + a / f32(500.0)
    fz = fy - b / f32(200.0)

    def inv(fv: torch.Tensor) -> torch.Tensor:
        return torch.where(fv <= f32(f_thresh),
                           (fv - f32(16.0 / 116.0)) / f32(7.787),
                           fv * fv * fv)

    x, z = inv(fx), inv(fz)
    coeffs = _XYZ_INV * _WHITE[None, :]          # whitepoint folded in
    red, green, blue = (x * f32(coeffs[i, 0]) + y * f32(coeffs[i, 1])
                        + z * f32(coeffs[i, 2]) for i in range(3))
    out = torch.stack([blue, green, red], dim=-1) * f32(255.0)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
