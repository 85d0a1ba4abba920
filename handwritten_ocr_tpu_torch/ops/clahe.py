"""CLAHE — contrast-limited adaptive histogram equalization.

Port of ``handwritten_ocr_tpu/ops/clahe.py:clahe`` (OpenCV semantics,
clip 3.0, 8x8 tiles): reflect101 padding to a tile multiple (including
OpenCV's quirk of padding both dims when either is unaligned), per-tile
256-bin histograms, clip and excess redistribution with OpenCV's strided
residual, a LUT per tile from the rounded scaled CDF, and bilinear
interpolation between the four neighbouring tiles' LUTs.

The histograms are integer counts (``bincount``) and the LUTs integer
valued, so both equal the JAX package's exactly; the interpolation gathers
the four LUT values per pixel where JAX uses a one-hot matmul, so a pixel
may round to the other neighbour of a .5 (at most 1 gray level).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def clahe(image: torch.Tensor, clip_limit: float = 3.0,
          tiles: tuple[int, int] = (8, 8)) -> torch.Tensor:
    """uint8 [H, W] grayscale → uint8 [H, W] (OpenCV CLAHE semantics)."""
    h, w = image.shape
    ty, tx = tiles
    if h % ty == 0 and w % tx == 0:
        pad_h = pad_w = 0
    else:
        pad_h = ty - h % ty
        pad_w = tx - w % tx
    tile_h = (h + pad_h) // ty
    tile_w = (w + pad_w) // tx
    padded = image
    if pad_h or pad_w:
        padded = F.pad(image.float()[None, None], (0, pad_w, 0, pad_h),
                       mode="reflect")[0, 0].to(torch.uint8)
    ph, pw = padded.shape
    device = image.device

    # Per-tile histograms [ty*tx, 256].
    tile_ids = (torch.arange(ty, device=device).repeat_interleave(tile_h)[:, None] * tx
                + torch.arange(tx, device=device).repeat_interleave(tile_w)[None, :])
    flat = (tile_ids * 256 + padded.long()).reshape(-1)
    hist = torch.bincount(flat, minlength=ty * tx * 256).reshape(ty * tx, 256)

    tile_area = tile_h * tile_w
    limit = max(int(clip_limit * tile_area / 256), 1)

    clipped = torch.clamp(hist, max=limit)
    excess = (hist - clipped).sum(dim=1)
    batch = excess // 256
    residual = excess - batch * 256
    redistributed = clipped + batch[:, None]
    idx = torch.arange(256, device=device)
    step = torch.clamp(256 // torch.clamp(residual, min=1), min=1)[:, None]
    gets_one = (idx[None, :] % step == 0) & (idx[None, :] // step < residual[:, None])
    redistributed = redistributed + gets_one.long()

    cdf = torch.cumsum(redistributed, dim=1)
    scale = 255.0 / tile_area
    luts = torch.clamp(torch.round(cdf.float() * scale), 0, 255)    # [T, 256]
    luts = luts.reshape(ty, tx, 256)

    ys = torch.arange(ph, dtype=torch.float32, device=device)
    xs = torch.arange(pw, dtype=torch.float32, device=device)
    tyf = ys / tile_h - 0.5
    txf = xs / tile_w - 0.5
    y0 = torch.clamp(torch.floor(tyf), 0, ty - 1).long()
    x0 = torch.clamp(torch.floor(txf), 0, tx - 1).long()
    y1 = torch.clamp(y0 + 1, 0, ty - 1)
    x1 = torch.clamp(x0 + 1, 0, tx - 1)
    wy = torch.clamp(tyf - torch.floor(tyf), 0.0, 1.0)
    wx = torch.clamp(txf - torch.floor(txf), 0.0, 1.0)
    # Border rows/cols outside the tile centres weigh 0 toward the clamp.
    wy = torch.where(tyf < 0, 0.0, torch.where(tyf > ty - 1, 1.0, wy))
    wx = torch.where(txf < 0, 0.0, torch.where(txf > tx - 1, 1.0, wx))

    px = padded.long()

    def lut(yi, xi):
        return luts[yi[:, None], xi[None, :], px]

    wy_c, wx_r = wy[:, None], wx[None, :]
    top = lut(y0, x0) * (1 - wx_r) + lut(y0, x1) * wx_r
    bottom = lut(y1, x0) * (1 - wx_r) + lut(y1, x1) * wx_r
    out = top * (1 - wy_c) + bottom * wy_c
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)[:h, :w]
