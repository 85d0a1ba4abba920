"""Qwen2.5-VL model glue: M-RoPE indexing and the image splice.

Port of ``rope_index_for_prompt`` and ``VLModel.prompt_embeds`` from
``handwritten_ocr_tpu/models/qwen25vl/model.py``. Decoding runs in the
continuous batcher (``engine/serving.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from handwritten_ocr_tpu_torch.config import SERVE_VISION_CHUNK
from handwritten_ocr_tpu_torch.models.qwen25vl.config import VLConfig
from handwritten_ocr_tpu_torch.models.qwen25vl.vision import vision_encode


def rope_index_for_prompt(ids: np.ndarray, config: VLConfig,
                          image_grids: list[tuple[int, int, int]],
                          ) -> tuple[np.ndarray, int]:
    """M-RoPE position ids for one prompt row (host numpy).

    HF ``get_rope_index`` semantics for image-only inputs: text spans
    advance all three planes together; each image span gets (t, h, w)
    grid coordinates offset to continue after the preceding text.
    Returns ([3, T] positions, rope_delta).
    """
    ids = np.asarray(ids)
    total = len(ids)
    positions = np.zeros((3, total), dtype=np.int64)
    image_positions = np.flatnonzero(ids == config.image_token_id)

    runs: list[tuple[int, int]] = []      # one contiguous run per image
    if len(image_positions):
        breaks = np.flatnonzero(np.diff(image_positions) > 1)
        starts = np.concatenate(([0], breaks + 1))
        ends = np.concatenate((breaks, [len(image_positions) - 1]))
        runs = [(int(image_positions[a]), int(image_positions[z]) + 1)
                for a, z in zip(starts, ends)]
    if len(runs) != len(image_grids):
        raise ValueError(f"{len(runs)} image-token runs vs "
                         f"{len(image_grids)} grids")

    cursor = 0
    next_pos = 0
    for (start, end), (t, h, w) in zip(runs, image_grids):
        merge = config.vision.spatial_merge_size
        gh, gw = h // merge, w // merge
        text_len = start - cursor
        positions[:, cursor:start] = next_pos + np.arange(text_len)
        next_pos += text_len
        t_idx = np.repeat(np.zeros(t, dtype=np.int64), gh * gw)
        h_idx = np.tile(np.repeat(np.arange(gh), gw), t)
        w_idx = np.tile(np.tile(np.arange(gw), gh), t)
        positions[0, start:end] = next_pos + t_idx
        positions[1, start:end] = next_pos + h_idx
        positions[2, start:end] = next_pos + w_idx
        next_pos = positions[:, start:end].max() + 1
        cursor = end
    tail = total - cursor
    positions[:, cursor:] = next_pos + np.arange(tail)

    delta = int(positions.max()) + 1 - total
    return positions, delta


class VLModel:
    """Parameters + config of a Qwen2.5-VL model in the port's layout."""

    def __init__(self, params: dict, config: VLConfig):
        self.params = params
        self.config = config

    def vision_embeds(self, patches: torch.Tensor, grid) -> torch.Tensor:
        """Vision tower over ``patches [B, S, C·T·ps·ps]``, in sequential
        chunks of SERVE_VISION_CHUNK pages (caps activation memory)."""
        chunk = max(1, SERVE_VISION_CHUNK)
        outs = [vision_encode(self.params["vision"], self.config.vision,
                              patches[lo:lo + chunk], grid)
                for lo in range(0, patches.shape[0], chunk)]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def splice_embeds(self, input_ids: torch.Tensor,
                      image_embeds: torch.Tensor) -> torch.Tensor:
        """Prompt embeddings with the image rows placed at the image tokens
        (one image per row, identical spans)."""
        embed_w = self.params["text"]["embed"]["w"]
        embeds = embed_w[input_ids]
        image_embeds = image_embeds.to(embeds.dtype)
        image_mask = input_ids == self.config.image_token_id
        slot = torch.clamp(torch.cumsum(image_mask.long(), dim=1) - 1,
                           0, image_embeds.shape[1] - 1)
        gathered = torch.take_along_dim(image_embeds, slot[..., None], dim=1)
        return torch.where(image_mask[..., None], gathered, embeds)

    def prompt_embeds(self, input_ids: torch.Tensor, patches: torch.Tensor,
                      grid) -> torch.Tensor:
        """Vision encode + splice: the paged prefill's input [B, T, D]."""
        return self.splice_embeds(input_ids, self.vision_embeds(patches, grid))
