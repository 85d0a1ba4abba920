"""Qwen2.5-VL model: M-RoPE indexing, the image splice, dense greedy
decode.

Port of ``handwritten_ocr_tpu/models/qwen25vl/model.py``. Serving decodes
in the continuous batcher (``engine/serving.py``); ``VLModel.generate``
is the dense path (one contiguous cache per call) and ``forward_logits``
the full-sequence parity entry point.

With a ``mesh`` (``parallel/mesh.py``) the parameters are the rank's
tensor-parallel slices (``parallel/sharding.py``) and every forward runs
over the rank's "model" group; without one, every method runs on one
device as before. With ``shardings`` (the FSDP specs of the tree,
``param_shardings(..., fsdp=True)``) the parameters are also split over
"data", and every forward gathers each layer just before it runs.
"""

from __future__ import annotations

import numpy as np
import torch

from handwritten_ocr_tpu_torch import config as cfg_mod
from handwritten_ocr_tpu_torch.models.layers import (argmax_ids, embed,
                                                     gather_columns,
                                                     group_size)
from handwritten_ocr_tpu_torch.models.qwen25vl.config import VLConfig
from handwritten_ocr_tpu_torch.models.qwen25vl.language import (
    GenerationResult, KVCache, greedy_decode, lm_logits, text_forward)
from handwritten_ocr_tpu_torch.models.qwen25vl.vision import vision_encode
from handwritten_ocr_tpu_torch.parallel.mesh import model_group
from handwritten_ocr_tpu_torch.parallel.sharding import (gathered,
                                                         layer_gather, scoped)


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
    """Parameters + config of a Qwen2.5-VL model in the port's layout;
    dense greedy decode on the parameters' device. ``mesh``: the
    tensor-parallel mesh the parameters are sliced for (None: whole);
    ``shardings``: their FSDP specs when they are split over "data" too."""

    def __init__(self, params: dict, config: VLConfig, mesh=None,
                 shardings=None):
        self.params = params
        self.config = config
        self.mesh = mesh
        self.shardings = shardings

    @property
    def group(self):
        """The rank's "model" process group (None on one device)."""
        return model_group(self.mesh)

    @property
    def gather(self):
        """The FSDP gather of the whole tree (None without FSDP)."""
        return layer_gather(self.mesh, self.shardings)

    def _text_embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        gather = scoped(self.gather, "text")
        return embed(gathered(gather, self.params["text"]["embed"], "embed"),
                     input_ids, self.group)

    def vision_embeds(self, patches: torch.Tensor, grid) -> torch.Tensor:
        """Vision tower over ``patches [B, S, C·T·ps·ps]``, in sequential
        chunks of ``config.SERVE_VISION_CHUNK`` pages (caps activation
        memory; read at each call, as the JAX model reads it)."""
        chunk = max(1, cfg_mod.SERVE_VISION_CHUNK)
        gather = scoped(self.gather, "vision")
        outs = [vision_encode(self.params["vision"], self.config.vision,
                              patches[lo:lo + chunk], grid, self.group,
                              gather)
                for lo in range(0, patches.shape[0], chunk)]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def splice_embeds(self, input_ids: torch.Tensor,
                      image_embeds: torch.Tensor) -> torch.Tensor:
        """Prompt embeddings with the image rows placed at the image tokens
        (one image per row, identical spans); the splice follows the
        vocab-parallel lookup's sum under TP."""
        embeds = self._text_embed(input_ids)
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

    def _positions(self, input_ids: np.ndarray, grid) -> tuple[torch.Tensor, int]:
        """[3, B, T] M-RoPE ids of rows that share row 0's layout, and the
        decode-step rope delta."""
        grids = [tuple(int(g) for g in grid)] if grid is not None else []
        row, delta = rope_index_for_prompt(input_ids[0], self.config, grids)
        positions = np.array(np.broadcast_to(row[:, None, :],
                                             (3, *input_ids.shape)))
        device = self.params["text"]["embed"]["w"].device
        return torch.as_tensor(positions, device=device), delta

    def _embeds(self, input_ids: torch.Tensor, patches, grid) -> torch.Tensor:
        if patches is None:
            return self._text_embed(input_ids)
        return self.prompt_embeds(input_ids, patches, grid)

    def _prefill(self, input_ids: torch.Tensor, patches, grid, max_new: int,
                 position_ids: torch.Tensor):
        """Vision encode + splice, then the prompt pass into a fresh cache
        of prompt + ``max_new`` rows; returns (first token [B], cache)."""
        text, cfg, group = self.params["text"], self.config.text, self.group
        gather = scoped(self.gather, "text")
        embeds = self._embeds(input_ids, patches, grid)
        batch, prompt_len = input_ids.shape
        cache = KVCache.zeros(cfg.num_hidden_layers, batch,
                              prompt_len + max_new,
                              cfg.num_key_value_heads // group_size(group),
                              cfg.head_dim, dtype=embeds.dtype,
                              device=embeds.device)
        hidden, cache = text_forward(text, cfg, embeds, position_ids, cache,
                                     group=group, gather=gather)
        logits = lm_logits(text, cfg, hidden[:, -1:], gather=gather)
        return argmax_ids(logits[:, -1], group), cache

    def _decode(self, max_new: int, first: torch.Tensor, cache: KVCache,
                rope_delta: int) -> GenerationResult:
        """Greedy steps at position cursor + rope_delta (all three M-RoPE
        planes)."""
        text, cfg, group = self.params["text"], self.config.text, self.group
        gather = scoped(self.gather, "text")

        def step_logits(step, prev):
            embeds = self._text_embed(prev.long())[:, None]
            position_ids = torch.full((3, prev.shape[0], 1),
                                      cache.cursor + rope_delta,
                                      device=prev.device)
            hidden, _ = text_forward(text, cfg, embeds, position_ids, cache,
                                     group=group, gather=gather)
            return lm_logits(text, cfg, hidden, gather=gather)[:, -1]

        return greedy_decode(step_logits, first, max_new,
                             self.config.eos_token_id, group)

    def generate(self, input_ids, patches: torch.Tensor | None, grid,
                 max_new_tokens: int) -> GenerationResult:
        """Greedy decode over a contiguous cache. Every row shares row 0's
        prompt layout (the strategies of one page)."""
        input_ids = np.asarray(input_ids, dtype=np.int64)
        position_ids, delta = self._positions(input_ids, grid)
        ids = torch.as_tensor(input_ids, device=position_ids.device)
        first, cache = self._prefill(ids, patches, grid, int(max_new_tokens),
                                     position_ids)
        return self._decode(int(max_new_tokens), first, cache, delta)

    def forward_logits(self, input_ids, patches: torch.Tensor | None = None,
                       grid=None) -> torch.Tensor:
        """Full-sequence fp32 logits [B, T, V] without a cache (under TP
        the vocab shards gathered, on every rank)."""
        input_ids = np.asarray(input_ids, dtype=np.int64)
        position_ids, _ = self._positions(input_ids, grid)
        ids = torch.as_tensor(input_ids, device=position_ids.device)
        gather = scoped(self.gather, "text")
        hidden, _ = text_forward(self.params["text"], self.config.text,
                                 self._embeds(ids, patches, grid),
                                 position_ids, group=self.group,
                                 gather=gather)
        return gather_columns(lm_logits(self.params["text"], self.config.text,
                                        hidden, gather=gather), self.group)
