"""Geometry for deskew: minimum-area rectangle (host) + affine warp (device).

Port of ``handwritten_ocr_tpu/ops/geometry.py``. Contract (reference
deskew): collect dark-pixel coordinates (gray < 128, (row, col) order),
skip if <= 100 points, take cv2.minAreaRect's angle, fold it, rotate about
the integer image centre with INTER_CUBIC over a replicate border. The
rectangle search is host numpy on the convex hull; the warp is a bicubic
gather on the image's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain; points [N, 2] float; hull CCW [M, 2]."""
    pts = np.unique(points, axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def half(iterable):
        chain: list[np.ndarray] = []
        for p in iterable:
            while len(chain) >= 2:
                u = chain[-1] - chain[-2]
                v = p - chain[-2]
                if u[0] * v[1] - u[1] * v[0] > 0:  # strict left turn keeps
                    break
                chain.pop()
            chain.append(p)
        return chain

    lower = half(pts)
    upper = half(pts[::-1])
    return np.array(lower[:-1] + upper[:-1])


def min_area_rect_angle(points: np.ndarray) -> float:
    """Angle (degrees) of the min-area rect, cv2 5.x convention [-90, 0)."""
    hull = convex_hull(points.astype(np.float64))
    if len(hull) <= 2:
        return -90.0
    best_area, best_angle = np.inf, 0.0
    edges = np.diff(np.vstack([hull, hull[:1]]), axis=0)
    for edge in edges:
        norm = math.hypot(edge[0], edge[1])
        if norm == 0:
            continue
        ux, uy = edge[0] / norm, edge[1] / norm
        proj_u = hull @ np.array([ux, uy])
        proj_v = hull @ np.array([-uy, ux])
        area = (proj_u.max() - proj_u.min()) * (proj_v.max() - proj_v.min())
        if area < best_area - 1e-9:
            best_area = area
            best_angle = math.degrees(math.atan2(uy, ux)) % 90.0
    return best_angle - 90.0


def deskew_angle(gray: np.ndarray, dark_threshold: int = 128,
                 min_points: int = 100) -> float | None:
    """Rotation angle for the reference deskew, or None to skip."""
    rows, cols = np.nonzero(gray < dark_threshold)
    if len(rows) <= min_points:
        return None
    coords = np.column_stack([rows, cols])  # (y, x) order as the reference
    angle = min_area_rect_angle(coords)
    if angle < -45:
        return -(90 + angle)
    return -angle


def rotation_matrix(center: tuple[float, float], angle_deg: float) -> np.ndarray:
    """cv2.getRotationMatrix2D(center, angle, 1.0) — the forward map."""
    alpha = math.cos(math.radians(angle_deg))
    beta = math.sin(math.radians(angle_deg))
    cx, cy = center
    return np.array([
        [alpha, beta, (1 - alpha) * cx - beta * cy],
        [-beta, alpha, beta * cx + (1 - alpha) * cy],
    ])


def _invert_affine(m: np.ndarray) -> np.ndarray:
    inv = np.linalg.inv(m[:, :2])
    t = -inv @ m[:, 2]
    return np.hstack([inv, t[:, None]])


def _cubic_weights(f: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Bicubic taps with A = -0.75 (cv2 INTER_CUBIC)."""
    a = -0.75
    w0 = ((a * (f + 1) - 5 * a) * (f + 1) + 8 * a) * (f + 1) - 4 * a
    w1 = ((a + 2) * f - (a + 3)) * f * f + 1
    g = 1 - f
    w2 = ((a + 2) * g - (a + 3)) * g * g + 1
    w3 = 1 - w0 - w1 - w2
    return w0, w1, w2, w3


def warp_affine_bicubic(image: torch.Tensor, matrix: np.ndarray,
                        out_shape: tuple[int, int] | None = None) -> torch.Tensor:
    """cv2.warpAffine(..., INTER_CUBIC, BORDER_REPLICATE) equivalent.

    ``matrix`` is the forward 2x3 map; uint8 [H, W] or [H, W, C] in and out.
    """
    h, w = image.shape[:2]
    out_h, out_w = out_shape or (h, w)
    inv = [[float(x) for x in row]
           for row in _invert_affine(np.asarray(matrix, np.float64))]
    device = image.device
    xs = torch.arange(out_w, dtype=torch.float32, device=device)
    ys = torch.arange(out_h, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    sx = inv[0][0] * gx + inv[0][1] * gy + inv[0][2]
    sy = inv[1][0] * gx + inv[1][1] * gy + inv[1][2]

    x_floor = torch.floor(sx)
    y_floor = torch.floor(sy)
    wx = _cubic_weights(sx - x_floor)
    wy = _cubic_weights(sy - y_floor)
    xi = x_floor.to(torch.int64)
    yi = y_floor.to(torch.int64)

    img_f = image.float()
    color = image.dim() == 3
    acc = torch.zeros((out_h, out_w) + tuple(image.shape[2:]),
                      dtype=torch.float32, device=device)
    for j in range(4):
        yy = torch.clamp(yi - 1 + j, 0, h - 1)
        row_acc = torch.zeros_like(acc)
        for i in range(4):
            xx = torch.clamp(xi - 1 + i, 0, w - 1)
            weight = wx[i][..., None] if color else wx[i]
            row_acc = row_acc + weight * img_f[yy, xx]
        weight_y = wy[j][..., None] if color else wy[j]
        acc = acc + weight_y * row_acc
    return torch.clamp(torch.round(acc), 0, 255).to(torch.uint8)
