"""Qwen3 text decoder: the reasoning engine's architecture.

Port of ``handwritten_ocr_tpu/models/qwen3.py``. Qwen3 is a Qwen2-style
GQA decoder with an RMSNorm over the head dim on Q and K before the
rotary embedding (``q_norm``/``k_norm``), no attention biases, an
explicit ``head_dim`` (qwen3:32b: 64 heads x 128 = 8192, not the hidden
5120) and 1D RoPE. It serves through the paged stack of
``models/paged.py`` in the continuous batcher; :class:`Qwen3Model` also
decodes greedily over a contiguous cache (``generate``, left-padded
batches; ``generate_json``, JSON-prefix-guarded), the dense path, and
gives full-sequence logits (``forward_logits``). With a ``mesh`` the
parameters are the rank's tensor-parallel slices and every forward runs
over its "model" group (``models/qwen25vl/model.py``).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from handwritten_ocr_tpu_torch.models.layers import (argmax_ids, embed,
                                                     gather_columns,
                                                     group_size, topk_ids)
from handwritten_ocr_tpu_torch.models.qwen25vl.language import (
    GenerationResult, KVCache, greedy_decode, lm_logits, text_forward)
from handwritten_ocr_tpu_torch.parallel.mesh import model_group
from handwritten_ocr_tpu_torch.parallel.sharding import gathered, layer_gather


@dataclasses.dataclass(frozen=True)
class Qwen3Config:
    """Defaults: qwen3:32b, the reference's reasoning model."""

    vocab_size: int = 151936
    hidden_size: int = 5120
    intermediate_size: int = 25600
    num_hidden_layers: int = 64
    num_attention_heads: int = 64
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    tie_word_embeddings: bool = False
    eos_token_id: int = 151645
    pad_token_id: int = 151643
    # 1D RoPE: position ids are [B, T] (models/qwen25vl/language.py).
    mrope_section = None

    @classmethod
    def from_hf(cls, cfg: dict) -> "Qwen3Config":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in cfg.items() if k in known}
        eos = kwargs.get("eos_token_id", 151645)
        if isinstance(eos, list):
            eos = eos[0]
        kwargs["eos_token_id"] = 151645 if eos is None else eos
        if kwargs.get("pad_token_id") is None:
            kwargs.pop("pad_token_id", None)
        return cls(**kwargs)

    @classmethod
    def from_pretrained_dir(cls, model_dir: str | Path) -> "Qwen3Config":
        return cls.from_hf(json.loads((Path(model_dir) / "config.json")
                                      .read_text()))


class Qwen3Model:
    """Parameters (a text tree: embed / layers / final_norm / lm_head, in
    the port's layout) and their config; greedy decode over a contiguous
    KV cache on the parameters' device. ``mesh``: the tensor-parallel
    mesh the parameters are sliced for (None: whole); ``shardings``:
    their FSDP specs when they are split over "data" too (every forward
    then gathers each layer just before it runs)."""

    def __init__(self, params: dict, config: Qwen3Config, mesh=None,
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
        """The FSDP gather of the tree (None without FSDP)."""
        return layer_gather(self.mesh, self.shardings)

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        return embed(gathered(self.gather, self.params["embed"], "embed"),
                     ids, self.group)

    @property
    def device(self) -> torch.device:
        return self.params["embed"]["w"].device

    def _ids(self, input_ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(input_ids, dtype=np.int64),
                               device=self.device)

    def _prompt_logits(self, input_ids: torch.Tensor, max_new: int,
                       key_padding: torch.Tensor | None = None):
        """Prompt pass into a fresh cache of prompt + ``max_new`` rows;
        returns (fp32 logits [B, V] of the last prompt token, cache, each
        row's last position). Left-padded rows (``key_padding`` False on
        the padding) take positions from 0 on their first real token."""
        cfg, group = self.config, self.group
        batch, prompt_len = input_ids.shape
        embeds = self._embed(input_ids)
        position_ids = torch.arange(prompt_len, device=self.device)[None] \
            .expand(batch, prompt_len)
        if key_padding is not None:
            offsets = torch.argmax(key_padding.to(torch.int32), dim=1)[:, None]
            position_ids = torch.clamp(position_ids - offsets, min=0)
        cache = KVCache.zeros(cfg.num_hidden_layers, batch,
                              prompt_len + max_new,
                              cfg.num_key_value_heads // group_size(group),
                              cfg.head_dim, dtype=embeds.dtype,
                              device=self.device)
        hidden, cache = text_forward(
            self.params, cfg, embeds, position_ids, cache,
            key_padding=_pad_to_cache(key_padding, prompt_len + max_new),
            group=group, gather=self.gather)
        logits = lm_logits(self.params, cfg, hidden[:, -1:],
                           gather=self.gather)[:, -1]
        return logits, cache, position_ids[:, -1]

    def _step_logits(self, tokens: torch.Tensor, cache: KVCache,
                     positions: torch.Tensor,
                     key_padding: torch.Tensor | None = None) -> torch.Tensor:
        """One decode step of ``tokens [B]`` at ``positions [B]`` over the
        cache (advanced in place); fp32 logits [B, V]."""
        group = self.group
        embeds = self._embed(tokens.long())[:, None]
        hidden, _ = text_forward(self.params, self.config, embeds,
                                 positions[:, None], cache,
                                 key_padding=key_padding, group=group,
                                 gather=self.gather)
        return lm_logits(self.params, self.config, hidden,
                         gather=self.gather)[:, -1]

    def _prefill(self, input_ids: torch.Tensor, max_new: int,
                 key_padding: torch.Tensor | None):
        """Returns (first token [B], cache, each row's last position)."""
        logits, cache, last_pos = self._prompt_logits(input_ids, max_new,
                                                      key_padding)
        return argmax_ids(logits, self.group), cache, last_pos

    def _decode(self, max_new: int, first: torch.Tensor, cache: KVCache,
                last_pos: torch.Tensor,
                key_padding: torch.Tensor | None) -> GenerationResult:
        """Greedy steps at each row's last position + step."""
        padding = _pad_to_cache(key_padding, cache.k.shape[2])
        return greedy_decode(
            lambda step, prev: self._step_logits(prev, cache, last_pos + step,
                                                 padding),
            first, max_new, self.config.eos_token_id, self.group)

    def _prefill_topk(self, input_ids: torch.Tensor, max_new: int, k: int):
        """Prefill returning the next token's top-k ids [B, k] and the
        cache (B = 1)."""
        logits, cache, _ = self._prompt_logits(input_ids, max_new)
        return topk_ids(logits, k, self.group), cache

    def _step_topk(self, token: torch.Tensor, cache: KVCache, k: int,
                   position: torch.Tensor):
        """One decode step returning the top-k ids [B, k] (B = 1)."""
        return (topk_ids(self._step_logits(token, cache, position), k,
                         self.group), cache)

    def generate_json(self, input_ids, max_new_tokens: int, tokenizer,
                      top_k: int = 64) -> str:
        """JSON-constrained greedy decode (B = 1): each step takes the
        device's top-k and commits the best candidate whose decoded text
        is still a viable JSON prefix (``utils/json_guard.py``); decoding
        stops once the document is complete. Returns the text, possibly
        an incomplete document when no candidate fits (the caller's parse
        ladder salvages it)."""
        from handwritten_ocr_tpu_torch.utils.json_guard import (
            is_complete, is_viable_prefix)
        ids = self._ids(input_ids)
        if ids.shape[0] != 1:
            raise ValueError("constrained decode takes one row")
        eos = self.config.eos_token_id
        idx, cache = self._prefill_topk(ids, int(max_new_tokens), top_k)
        prompt_len = ids.shape[1]
        generated: list[int] = []
        text = ""
        for step in range(max_new_tokens):
            chosen = None
            for token in idx[0].tolist():
                if token == eos:
                    if is_complete(text):
                        return text
                    continue
                candidate_text = tokenizer.decode(generated + [token])
                if is_viable_prefix(candidate_text.rstrip("\ufffd")):
                    chosen = token
                    text = candidate_text
                    break
            if chosen is None:
                break               # no viable continuation
            generated.append(chosen)
            if "\ufffd" not in text and is_complete(text):
                return text
            idx, cache = self._step_topk(
                torch.tensor([chosen], device=self.device), cache, top_k,
                torch.full((1,), prompt_len + step, device=self.device))
        return text

    def generate(self, input_ids, max_new_tokens: int,
                 pad_mask=None) -> GenerationResult:
        """Greedy decode of ``input_ids [B, T]``; ``pad_mask`` True on the
        real tokens of left-padded rows."""
        ids = self._ids(input_ids)
        padding = (None if pad_mask is None else
                   torch.as_tensor(np.asarray(pad_mask, dtype=bool),
                                   device=self.device))
        first, cache, last_pos = self._prefill(ids, int(max_new_tokens),
                                               padding)
        return self._decode(int(max_new_tokens), first, cache, last_pos,
                            padding)

    def forward_logits(self, input_ids) -> torch.Tensor:
        """Full-sequence fp32 logits [B, T, V] without a cache (under TP
        the vocab shards gathered, on every rank)."""
        ids = self._ids(input_ids)
        batch, seq = ids.shape
        position_ids = torch.arange(seq, device=self.device)[None] \
            .expand(batch, seq)
        group = self.group
        hidden, _ = text_forward(self.params, self.config,
                                 self._embed(ids),
                                 position_ids, group=group,
                                 gather=self.gather)
        return gather_columns(lm_logits(self.params, self.config, hidden,
                                        gather=self.gather), group)


def _pad_to_cache(key_padding: torch.Tensor | None,
                  cache_len: int) -> torch.Tensor | None:
    """A prompt-length padding mask extended to the cache length (the new
    rows are real)."""
    if key_padding is None:
        return None
    batch, prompt_len = key_padding.shape
    extra = torch.ones((batch, cache_len - prompt_len), dtype=torch.bool,
                       device=key_padding.device)
    return torch.cat([key_padding, extra], dim=1)
