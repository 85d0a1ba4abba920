"""Windowed ViT encoder (Qwen2.5-VL vision tower), batched over pages.

Port of ``handwritten_ocr_tpu/models/qwen25vl/vision.py``. A batch of B
images with identical grids runs as [B, P, D] in the padded window
layout: tokens grouped into uniform windows (edge windows padded with
dead slots) for the whole stack. The window layers call
:func:`window_attention`, the global layers :func:`flash_attention` with a
dead-slot key mask. One gather enters the layout after patch embedding;
one gather leaves it before the patch merger.

Dead slots attend to nothing in the flash kernel and come out as 0 where
the JAX CPU path (``layers.attention``) averages v uniformly; the merger's
gather drops them, so only live rows reach the output.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from handwritten_ocr_tpu_torch.models.layers import (apply_rope, gelu_mlp,
                                                     linear, rms_norm,
                                                     swiglu_mlp)
from handwritten_ocr_tpu_torch.models.qwen25vl.config import VisionConfig
from handwritten_ocr_tpu_torch.ops.flash_attention import flash_attention
from handwritten_ocr_tpu_torch.ops.window_attention import window_attention

_NORM_EPS = 1e-6  # vision blocks use a fixed 1e-6 (HF Qwen2RMSNorm(eps=1e-6))


@dataclasses.dataclass(frozen=True)
class GridPlan:
    """Host-precomputed layout for one (t, h, w) patch grid."""

    grid: tuple[int, int, int]
    cell_perm: np.ndarray          # [n_cells] window-order permutation of 2x2 cells
    cell_unperm: np.ndarray        # [n_cells] inverse permutation
    n_windows: int
    window_len: int
    pad_from_flat: np.ndarray      # [P] permuted-token source per padded slot
    valid: np.ndarray              # [P] bool: real token (not a dead slot)
    flat_from_win: np.ndarray      # [S] permuted position -> padded slot
    cos_pad: np.ndarray            # [P, head_dim] rotary cos (padded layout)
    sin_pad: np.ndarray            # [P, head_dim] rotary sin (padded layout)


@functools.lru_cache(maxsize=32)
def plan_grid(cfg: VisionConfig, grid: tuple[int, int, int]) -> GridPlan:
    """Precompute permutations, padded-window layout, and rotary tables."""
    t, h, w = grid
    merge = cfg.spatial_merge_size
    unit = cfg.spatial_merge_unit
    cells_h, cells_w = h // merge, w // merge
    n_cells = t * cells_h * cells_w
    seq_len = t * h * w

    # Window partition of the cell grid, edge windows smaller. As HF's
    # get_window_index, the grid pads by (win - size % win) even when it
    # is aligned, and all-empty windows are dropped.
    win_cells = cfg.window_size // merge // cfg.patch_size
    pad_h = win_cells - cells_h % win_cells
    pad_w = win_cells - cells_w % win_cells
    n_win_h = (cells_h + pad_h) // win_cells
    n_win_w = (cells_w + pad_w) // win_cells

    cell_index = np.arange(n_cells).reshape(t, cells_h, cells_w)
    padded = np.full((t, cells_h + pad_h, cells_w + pad_w), -1, dtype=np.int64)
    padded[:, :cells_h, :cells_w] = cell_index
    padded = (
        padded.reshape(t, n_win_h, win_cells, n_win_w, win_cells)
        .transpose(0, 1, 3, 2, 4)
        .reshape(t * n_win_h * n_win_w, win_cells * win_cells)
    )
    window_cell_lists = [row[row >= 0] for row in padded if (row >= 0).any()]
    cell_perm = np.concatenate(window_cell_lists)
    cell_unperm = np.argsort(cell_perm)

    # Padded window layout: every window spans window_len slots; a
    # window's valid tokens occupy its first len(cells)*unit slots.
    window_len = win_cells * win_cells * unit
    n_windows = len(window_cell_lists)
    total = n_windows * window_len
    pad_from_flat = np.zeros(total, dtype=np.int64)
    valid = np.zeros(total, dtype=bool)
    flat_from_win = np.zeros(seq_len, dtype=np.int64)
    offset = 0
    for wi, cells in enumerate(window_cell_lists):
        n_tok = len(cells) * unit
        token_ids = np.arange(offset, offset + n_tok)
        slots = wi * window_len + np.arange(n_tok)
        pad_from_flat[slots] = token_ids
        valid[slots] = True
        flat_from_win[token_ids] = slots
        offset += n_tok

    # 2D rotary table in cell-major patch order, placed into the padded
    # layout (HF rot_pos_emb: h/w ids arranged cell-major).
    hpos = np.arange(h)[:, None].repeat(w, axis=1)
    wpos = np.arange(w)[None, :].repeat(h, axis=0)

    def cell_major(x: np.ndarray) -> np.ndarray:
        return (x.reshape(cells_h, merge, cells_w, merge)
                 .transpose(0, 2, 1, 3).reshape(-1))

    hpos_ids = np.tile(cell_major(hpos), t)
    wpos_ids = np.tile(cell_major(wpos), t)

    half = cfg.head_dim // 2
    inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, half, 2, dtype=np.float64) / half))
    freq_h = hpos_ids[:, None] * inv_freq[None, :]
    freq_w = wpos_ids[:, None] * inv_freq[None, :]
    rot = np.concatenate([freq_h, freq_w], axis=-1)        # [S, head_dim/2]
    emb = np.concatenate([rot, rot], axis=-1)              # [S, head_dim]
    token_perm = (cell_perm[:, None] * unit + np.arange(unit)[None, :]).reshape(-1)
    cos_perm = np.cos(emb)[token_perm].astype(np.float32)
    sin_perm = np.sin(emb)[token_perm].astype(np.float32)
    cos_pad = np.zeros((total, cfg.head_dim), np.float32)
    sin_pad = np.zeros((total, cfg.head_dim), np.float32)
    cos_pad[flat_from_win] = cos_perm
    sin_pad[flat_from_win] = sin_perm

    return GridPlan(grid=grid, cell_perm=cell_perm, cell_unperm=cell_unperm,
                    n_windows=n_windows, window_len=window_len,
                    pad_from_flat=pad_from_flat, valid=valid,
                    flat_from_win=flat_from_win, cos_pad=cos_pad,
                    sin_pad=sin_pad)


def _attend_full(params: dict, cfg: VisionConfig, x: torch.Tensor,
                 cos: torch.Tensor, sin: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Global attention over the padded sequence (dead slots key-masked)."""
    b, p, _ = x.shape
    q, k, v = linear(params["qkv"], x).reshape(b, p, 3, cfg.num_heads, -1).unbind(2)
    q, k = apply_rope(q, k, cos[None, :, None, :], sin[None, :, None, :])
    out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          valid, scale=cfg.head_dim ** -0.5)
    return linear(params["proj"], out.reshape(b, p, -1))


def _attend_windows(params: dict, cfg: VisionConfig, x: torch.Tensor,
                    cos: torch.Tensor, sin: torch.Tensor, valid: torch.Tensor,
                    window_len: int) -> torch.Tensor:
    """Attention within uniform windows, on the packed qkv projection."""
    out = window_attention(linear(params["qkv"], x), cos, sin, valid,
                           num_heads=cfg.num_heads, window_len=window_len,
                           scale=cfg.head_dim ** -0.5)
    return linear(params["proj"], out)


def vision_encode(params: dict, cfg: VisionConfig, patches: torch.Tensor,
                  grid: tuple[int, int, int]) -> torch.Tensor:
    """Encode a batch of identically-gridded images.

    patches: [B, S, C*T*ps*ps] in HF processor patch order (cell-major).
    Returns merged image embeddings [B, S/merge_unit, out_hidden_size] in
    the original (unpermuted) cell order.
    """
    plan = plan_grid(cfg, tuple(int(g) for g in grid))
    device = patches.device
    b, s, _ = patches.shape
    unit = cfg.spatial_merge_unit

    # The tower runs in the parameter dtype (packed patches are fp32).
    weight = params["patch_embed"]["w"]
    x = patches.to(weight.dtype) @ weight.t()                   # [B, S, D]

    # One gather into the padded window layout: the cell permutation and
    # the padding composed into a single index.
    token_perm = (plan.cell_perm[:, None] * unit + np.arange(unit)).reshape(-1)
    index = torch.as_tensor(token_perm[plan.pad_from_flat], device=device)
    valid = torch.as_tensor(plan.valid, device=device)
    x = x[:, index] * valid[:, None].to(x.dtype)

    cos = torch.as_tensor(plan.cos_pad, device=device)
    sin = torch.as_tensor(plan.sin_pad, device=device)
    full_layers = set(cfg.fullatt_block_indexes)
    for i, layer in enumerate(params["blocks"]):
        normed = rms_norm(layer["norm1"], x, _NORM_EPS)
        if i in full_layers:
            x = x + _attend_full(layer["attn"], cfg, normed, cos, sin, valid)
        else:
            x = x + _attend_windows(layer["attn"], cfg, normed, cos, sin,
                                    valid, plan.window_len)
        x = x + swiglu_mlp(layer["mlp"], rms_norm(layer["norm2"], x, _NORM_EPS))

    # One gather back to the permuted (unpadded) order, then the merger:
    # RMSNorm per patch, fold each cell's `unit` patches, MLP to LM width.
    x = x[:, torch.as_tensor(plan.flat_from_win, device=device)]
    merger = params["merger"]
    x = rms_norm(merger["ln_q"], x, _NORM_EPS)
    x = gelu_mlp(merger, x.reshape(b, s // unit, unit * x.shape[-1]))
    return x[:, torch.as_tensor(plan.cell_unperm, device=device)]
