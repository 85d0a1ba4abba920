"""Plain NumPy preprocessing: the strategy chains of the OCR cells and the
Qwen2-VL patch packing, on the raw page the benchmark made.

OpenCV's semantics, written out from the functions' documented
behaviour: ``cvtColor(RGB2GRAY)`` in Q15 fixed point; ``CLAHE`` (clip
3.0, 8x8 tiles, reflect-101 padding of both axes when either is
unaligned, excess redistributed with a strided residual, LUTs from the
rounded scaled CDF, bilinear between tile centres); ``adaptiveThreshold``
(GAUSSIAN_C, block 21, C = 10, replicate border); deskew by
``minAreaRect`` of the dark pixels and ``warpAffine`` (INTER_CUBIC,
A = -0.75, replicate border). Sums run in float32 in the order OpenCV's
separable filters take, so the result is the exact uint8 image.
"""

from __future__ import annotations

import math

import numpy as np

F32 = np.float32
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=F32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=F32)


def gray(image: np.ndarray) -> np.ndarray:
    if image.ndim == 2:
        return image
    r, g = 9798, 19235
    b = (1 << 15) - r - g
    rgb = image.astype(np.int64)
    return ((r * rgb[..., 0] + g * rgb[..., 1] + b * rgb[..., 2]
             + (1 << 14)) >> 15).astype(np.uint8)


def _reflect101(n: int, lo: int, hi: int) -> np.ndarray:
    index = np.arange(-lo, n + hi)
    period = 2 * (n - 1)
    index = np.remainder(index, period)
    return np.where(index >= n, period - index, index)


def clahe(image: np.ndarray, clip: float = 3.0, tiles: int = 8) -> np.ndarray:
    h, w = image.shape
    if h % tiles == 0 and w % tiles == 0:
        pad_h = pad_w = 0
    else:
        pad_h, pad_w = tiles - h % tiles, tiles - w % tiles
    padded = image[_reflect101(h, 0, pad_h)][:, _reflect101(w, 0, pad_w)]
    ph, pw = padded.shape
    th, tw = ph // tiles, pw // tiles
    area = th * tw
    hist = np.zeros((tiles, tiles, 256), np.int64)
    for ty in range(tiles):
        for tx in range(tiles):
            tile = padded[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw]
            hist[ty, tx] = np.bincount(tile.reshape(-1), minlength=256)
    limit = max(int(clip * area / 256), 1)
    clipped = np.minimum(hist, limit)
    excess = (hist - clipped).sum(-1, keepdims=True)
    batch, residual = excess // 256, excess % 256
    step = np.maximum(256 // np.maximum(residual, 1), 1)
    idx = np.arange(256)
    extra = (idx % step == 0) & (idx // step < residual)
    cdf = np.cumsum(clipped + batch + extra, axis=-1)
    luts = np.clip(np.round(cdf.astype(F32) * F32(255.0 / area)), 0, 255)

    def axis(n: int, size: int):
        t = np.arange(n, dtype=F32) / F32(size) - F32(0.5)
        lo = np.clip(np.floor(t), 0, tiles - 1).astype(np.int64)
        hi = np.clip(lo + 1, 0, tiles - 1)
        wt = np.clip(t - np.floor(t), F32(0), F32(1))
        wt = np.where(t < 0, F32(0), np.where(t > tiles - 1, F32(1), wt))
        return lo, hi, wt.astype(F32)

    y0, y1, wy = axis(ph, th)
    x0, x1, wx = axis(pw, tw)
    px = padded.astype(np.int64)

    def lut(yi, xi):
        return luts[yi[:, None], xi[None, :], px]

    wy, wx = wy[:, None], wx[None, :]
    top = lut(y0, x0) * (F32(1) - wx) + lut(y0, x1) * wx
    bottom = lut(y1, x0) * (F32(1) - wx) + lut(y1, x1) * wx
    out = top * (F32(1) - wy) + bottom * wy
    return np.clip(np.round(out), 0, 255).astype(np.uint8)[:h, :w]


def adaptive_threshold(image: np.ndarray, block: int = 21,
                       c: int = 10) -> np.ndarray:
    sigma = 0.3 * ((block - 1) * 0.5 - 1) + 0.8
    xs = np.arange(block, dtype=np.float64) - (block - 1) * 0.5
    kernel = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    taps = (kernel / kernel.sum()).astype(F32)
    h, w = image.shape
    pad = block // 2
    rows = np.clip(np.arange(-pad, h + pad), 0, h - 1)
    cols = np.clip(np.arange(-pad, w + pad), 0, w - 1)
    x = image.astype(F32)[rows][:, cols]
    acc = x[:, 0:w] * taps[0]
    for i in range(1, block):
        acc = acc + x[:, i:i + w] * taps[i]
    out = acc[0:h] * taps[0]
    for i in range(1, block):
        out = out + acc[i:i + h] * taps[i]
    mean = np.clip(np.round(out), 0, 255).astype(np.int64)
    return np.where(image.astype(np.int64) > mean - c, 255, 0).astype(np.uint8)


def _hull(points: np.ndarray) -> np.ndarray:
    """Convex hull (monotone chain), counter-clockwise, no collinear
    points."""
    pts = np.unique(points, axis=0)
    if len(pts) <= 2:
        return pts

    def chain(seq):
        out: list = []
        for p in seq:
            while len(out) >= 2:
                a, b = out[-2], out[-1]
                if (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0]) > 0:
                    break
                out.pop()
            out.append(p)
        return out

    lower, upper = chain(pts), chain(pts[::-1])
    return np.array(lower[:-1] + upper[:-1], dtype=np.float64)


def deskew_angle(g: np.ndarray) -> float | None:
    """The rotation (degrees) that deskews: minAreaRect of the (row, col)
    coordinates of the pixels under 128, in OpenCV's [-90, 0) angle
    convention, folded to the nearer axis; None at 100 points or fewer."""
    rows, cols = np.nonzero(g < 128)
    if len(rows) <= 100:
        return None
    hull = _hull(np.column_stack([rows, cols]).astype(np.float64))
    if len(hull) <= 2:
        angle = -90.0
    else:
        best, angle = np.inf, 0.0
        for a, b in zip(hull, np.roll(hull, -1, axis=0)):
            ux, uy = b - a
            norm = math.hypot(ux, uy)
            if norm == 0:
                continue
            ux, uy = ux / norm, uy / norm
            u = hull @ np.array([ux, uy])
            v = hull @ np.array([-uy, ux])
            area = (u.max() - u.min()) * (v.max() - v.min())
            if area < best - 1e-9:
                best = area
                angle = math.degrees(math.atan2(uy, ux)) % 90.0
        angle -= 90.0
    return -(90 + angle) if angle < -45 else -angle


def _cubic(f: np.ndarray):
    a = F32(-0.75)
    w0 = ((a * (f + 1) - 5 * a) * (f + 1) + 8 * a) * (f + 1) - 4 * a
    w1 = ((a + 2) * f - (a + 3)) * f * f + 1
    g = F32(1) - f
    w2 = ((a + 2) * g - (a + 3)) * g * g + 1
    return w0, w1, w2, F32(1) - w0 - w1 - w2


def deskew(image: np.ndarray) -> np.ndarray:
    angle = deskew_angle(gray(image))
    if angle is None:
        return image
    h, w = image.shape[:2]
    cx, cy = w // 2, h // 2
    alpha, beta = math.cos(math.radians(angle)), math.sin(math.radians(angle))
    forward = np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                        [-beta, alpha, beta * cx + (1 - alpha) * cy]])
    inv = np.linalg.inv(forward[:, :2])
    inv = np.hstack([inv, (-inv @ forward[:, 2])[:, None]])
    gy, gx = np.meshgrid(np.arange(h, dtype=F32), np.arange(w, dtype=F32),
                         indexing="ij")
    sx = F32(inv[0, 0]) * gx + F32(inv[0, 1]) * gy + F32(inv[0, 2])
    sy = F32(inv[1, 0]) * gx + F32(inv[1, 1]) * gy + F32(inv[1, 2])
    fx, fy = np.floor(sx), np.floor(sy)
    wx, wy = _cubic(sx - fx), _cubic(sy - fy)
    xi, yi = fx.astype(np.int64), fy.astype(np.int64)
    img = image.astype(F32)
    color = image.ndim == 3
    acc = np.zeros(img.shape, F32)
    for j in range(4):
        yy = np.clip(yi - 1 + j, 0, h - 1)
        row = np.zeros(img.shape, F32)
        for i in range(4):
            xx = np.clip(xi - 1 + i, 0, w - 1)
            weight = wx[i][..., None] if color else wx[i]
            row = row + weight * img[yy, xx]
        acc = acc + (wy[j][..., None] if color else wy[j]) * row
    return np.clip(np.round(acc), 0, 255).astype(np.uint8)


TRANSFORMS = {
    "deskew": deskew,
    "high_contrast": lambda image: clahe(gray(image)),
    "binarize": lambda image: adaptive_threshold(gray(image)),
}


def apply(image: np.ndarray, strategy) -> np.ndarray:
    for step in strategy:
        image = TRANSFORMS[step](image)
    return image


def patches(image: np.ndarray, patch: int = 14, merge: int = 2,
            temporal: int = 2) -> tuple[np.ndarray, tuple[int, int, int]]:
    """Qwen2-VL packing of an image already at its processor size (the
    cells' pages are: 924x672 needs no smart resize): [0, 1] rescale, CLIP
    normalisation, the frame repeated over the temporal patch, patches in
    cell-major order, each flattened (C, T, ps, ps)."""
    if image.ndim == 2:
        image = np.stack([image] * 3, axis=-1)
    h, w = image.shape[:2]
    factor = patch * merge
    if h % factor or w % factor or not 256 * 256 <= h * w <= 1024 * 1024:
        raise ValueError(f"a {h}x{w} page is not at its processor size "
                         "(28-aligned, 256^2 to 1024^2 pixels): the reference "
                         "does not resize")
    pixels = (image.astype(F32) / F32(255.0) - CLIP_MEAN) / CLIP_STD
    chw = pixels.transpose(2, 0, 1)
    frames = np.broadcast_to(chw, (temporal, *chw.shape))
    gh, gw = h // patch, w // patch
    packed = frames.reshape(temporal, 3, gh // merge, merge, patch,
                            gw // merge, merge, patch)
    packed = packed.transpose(2, 5, 3, 6, 1, 0, 4, 7)
    return (np.ascontiguousarray(packed.reshape(gh * gw, -1)), (1, gh, gw))
