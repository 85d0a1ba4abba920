"""Continuous batching over the paged KV cache.

Port of the plain-decode serving loop of
``handwritten_ocr_tpu/engine/serving.py``: a fixed set of S decode slots
steps together in chunks; at every chunk boundary the host retires the
sequences that hit EOS or their budget (freeing their blocks at once) and
admits queued requests into the freed slots. Guided decode, speculation
and the stop-mask cache stay in the JAX package for a later slice.

Greedy argmax runs on fp32 logits on the device, and so do the EOS and
budget stops; the host reads one flag per step to end a chunk early when
every slot is done, and the chunk's tokens at its end.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Sequence

import numpy as np
import torch

from handwritten_ocr_tpu_torch.models.paged import PagedKVCache, paged_forward
from handwritten_ocr_tpu_torch.models.qwen25vl.language import lm_logits


@dataclasses.dataclass
class GenRequest:
    """One generation job for the batcher."""

    prompt_ids: np.ndarray                      # [T] int32
    max_new: int
    on_tokens: Callable[[list[int], bool], None] | None = None
    # M-RoPE inputs (VL path): full [3, T] prompt positions and the
    # decode-step rope delta; None = 1D RoPE from arange.
    positions: np.ndarray | None = None
    rope_delta: int = 0
    # Pre-spliced prompt embeddings [T, D] (VL vision splice); None =
    # embedding-table lookup of prompt_ids.
    embeds: torch.Tensor | None = None
    # Filled by the batcher:
    tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False

    def _emit(self, new_tokens: list[int], done: bool) -> None:
        self.tokens.extend(new_tokens)
        self.done = done
        if self.on_tokens is not None and (new_tokens or done):
            self.on_tokens(new_tokens, done)


class PagedProgram:
    """Paged prefill + chunked greedy decode over one decoder stack.

    ``params`` is a text tree in the port's layout (embed / layers /
    final_norm / lm_head), e.g. a VL model's ``params["text"]``.
    """

    def __init__(self, params: dict, cfg, *, eos_token_id: int | None = None):
        self.params = params
        self.cfg = cfg
        self.eos_token_id = (eos_token_id if eos_token_id is not None
                             else cfg.eos_token_id)
        self.mrope = getattr(cfg, "mrope_section", None) is not None

    def prefill(self, cache: PagedKVCache, embeds: torch.Tensor,
                positions: torch.Tensor, true_len: torch.Tensor,
                slot_ids: torch.Tensor) -> torch.Tensor:
        """Fresh prefill of right-padded prompts; returns each row's first
        generated token [B] (device int32)."""
        start = torch.zeros_like(true_len)
        hidden = paged_forward(self.params, self.cfg, embeds, positions,
                               cache, slot_ids, start, true_len, fresh=True)
        rows = torch.arange(hidden.shape[0], device=hidden.device)
        last_hidden = hidden[rows, true_len.long() - 1][:, None]
        logits = lm_logits(self.params, self.cfg, last_hidden)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)

    def _step(self, cache: PagedKVCache, slot_ids: torch.Tensor,
              last: torch.Tensor, done: torch.Tensor,
              rope_delta: torch.Tensor,
              table_pages: int | None) -> torch.Tensor:
        """One greedy step for every slot: the next token [S] int32, EOS
        for a done slot (which appends nothing and skips its attention)."""
        start = cache.lengths.clone()
        pos = (start + rope_delta)[:, None]
        if self.mrope:
            pos = pos[None].expand(3, last.shape[0], 1)
        embeds = self.params["embed"]["w"][last.long()][:, None]
        hidden = paged_forward(self.params, self.cfg, embeds, pos, cache,
                               slot_ids, start, start + 1, attn_valid=~done,
                               table_pages=table_pages)
        logits = lm_logits(self.params, self.cfg, hidden)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return torch.where(done, torch.full_like(nxt, self.eos_token_id), nxt)

    def decode_chunk(self, cache: PagedKVCache, last: torch.Tensor,
                     done: torch.Tensor, remaining: torch.Tensor,
                     rope_delta: torch.Tensor, chunk: int,
                     table_pages: int | None = None):
        """Up to ``chunk`` greedy steps for every slot; a done slot emits
        EOS and skips its attention. Ends early once every slot is done.
        Returns (tokens [S, chunk], last [S], done [S]) on the device."""
        eos = self.eos_token_id
        n_slots = last.shape[0]
        slot_ids = torch.arange(n_slots, device=last.device)
        tokens = torch.full((n_slots, chunk), eos, dtype=torch.int32,
                            device=last.device)
        for i in range(chunk):
            if bool(done.all()):
                break
            nxt = self._step(cache, slot_ids, last, done, rope_delta,
                             table_pages)
            tokens[:, i] = nxt
            done = done | (nxt == eos) | (i + 1 >= remaining)
            last = nxt
        return tokens, last, done

    def embed_prompt(self, ids: torch.Tensor) -> torch.Tensor:
        """Default prompt embedding (no vision splice): table lookup."""
        return self.params["embed"]["w"][ids]


class ContinuousBatcher:
    """Slot/block scheduler driving a :class:`PagedProgram`.

    n_slots: decode batch width; block_size: KV block granularity (tokens);
    n_blocks: pool size (block 0 is the trash sink); max_context: per-
    sequence bound (table width); chunk: decode steps per dispatch when a
    live request streams tokens, throughput_chunk otherwise;
    prefill_bucket: prompt lengths pad up to a multiple of this.

    ``stats`` accumulates host-clock seconds of prefill and decode (each
    ends in a device-to-host read, so the times include the device work)
    and the tokens the decode chunks emitted.
    """

    # Prefill activations scale with rows x bucket tokens; cap the rows
    # per prefill call.
    PREFILL_GROUP_TOKENS = 32768

    def __init__(self, program: PagedProgram, *, n_slots: int = 8,
                 block_size: int = 64, n_blocks: int | None = None,
                 max_context: int = 4096, chunk: int = 16,
                 prefill_bucket: int = 128, dtype=torch.bfloat16,
                 device="cpu", throughput_chunk: int | None = None):
        cfg = program.cfg
        self.program = program
        self.device = torch.device(device)
        self.n_slots = n_slots
        self.block_size = block_size
        self.max_context = max_context
        self.max_blocks = -(-max_context // block_size)
        if n_blocks is None:
            n_blocks = 1 + n_slots * self.max_blocks
        self.n_blocks = n_blocks
        self.chunk = chunk
        self.throughput_chunk = throughput_chunk or chunk
        self.prefill_bucket = prefill_bucket
        self.cache = PagedKVCache.zeros(
            cfg.num_hidden_layers, n_blocks, block_size, n_slots,
            self.max_blocks, cfg.num_key_value_heads, cfg.head_dim,
            dtype=dtype, device=self.device)
        self._free_blocks: list[int] = list(range(n_blocks - 1, 0, -1))
        self._tables = np.zeros((n_slots, self.max_blocks), np.int32)
        self._free_slots: list[int] = list(range(n_slots - 1, -1, -1))
        self._slot_req: dict[int, GenRequest] = {}
        self._slot_blocks: dict[int, list[int]] = {}
        self._last = np.full((n_slots,), program.eos_token_id, np.int32)
        self._rope_delta = np.zeros((n_slots,), np.int32)
        # Host mirror of each slot's cache length; drives the table-width
        # ladder (attention reads scale with the table width).
        self._host_len = np.zeros((n_slots,), np.int64)
        self.stats = {"prefill_s": 0.0, "decode_s": 0.0, "decode_tokens": 0}

    def _tensor(self, array) -> torch.Tensor:
        return torch.as_tensor(np.asarray(array), device=self.device)

    def _table_pages(self, slots, margin: int) -> int | None:
        """Narrowest power-of-two page count (>= 8) covering ``host_len +
        margin`` of every slot in ``slots``; None = the full table."""
        slots = list(slots)
        if not slots:
            return None
        needed = max(self._host_len[slot] for slot in slots) + margin
        blocks = -(-int(needed) // self.block_size)
        width = 8
        while width < blocks:
            width *= 2
        return None if width >= self.max_blocks else width

    # ── admission ─────────────────────────────────────────────────
    def _blocks_needed(self, request: GenRequest) -> int:
        total = min(len(request.prompt_ids) + request.max_new,
                    self.max_context)
        return -(-total // self.block_size)

    def _try_admit(self, queue: deque) -> list[tuple[int, GenRequest]]:
        admitted = []
        while queue and self._free_slots:
            request = queue[0]
            need = self._blocks_needed(request)
            if need > len(self._free_blocks):
                break                      # head of line waits for frees
            queue.popleft()
            slot = self._free_slots.pop()
            blocks = [self._free_blocks.pop() for _ in range(need)]
            self._tables[slot] = 0
            self._tables[slot, :need] = blocks
            self._slot_req[slot] = request
            self._slot_blocks[slot] = blocks
            self._rope_delta[slot] = request.rope_delta
            admitted.append((slot, request))
        return admitted

    def _retire(self, slot: int) -> None:
        self._free_blocks.extend(self._slot_blocks.pop(slot))
        self._slot_req.pop(slot)
        self._free_slots.append(slot)
        self._tables[slot] = 0

    def _prefill_groups(self, admitted):
        """(bucket, sub-group) prefill calls: grouped by padded prompt
        length, each capped at PREFILL_GROUP_TOKENS padded tokens."""
        by_bucket: dict[int, list[tuple[int, GenRequest]]] = {}
        for slot, request in admitted:
            bucket = max(self.prefill_bucket,
                         -(-len(request.prompt_ids) // self.prefill_bucket)
                         * self.prefill_bucket)
            by_bucket.setdefault(bucket, []).append((slot, request))
        for bucket, group in by_bucket.items():
            rows = max(1, self.PREFILL_GROUP_TOKENS // bucket)
            for lo in range(0, len(group), rows):
                yield bucket, group[lo:lo + rows]

    def _prefill_admitted(self, admitted: list[tuple[int, GenRequest]]) -> None:
        t0 = time.perf_counter()
        self.cache.block_tables.copy_(self._tensor(self._tables))
        for bucket, group in self._prefill_groups(admitted):
            slots = np.array([s for s, _ in group], np.int64)
            true_len = np.array([len(r.prompt_ids) for _, r in group], np.int32)
            embeds, positions = self._build_prompt_inputs(group, bucket)
            first = self.program.prefill(self.cache, embeds, positions,
                                         self._tensor(true_len),
                                         self._tensor(slots)).tolist()
            for row, (slot, request) in enumerate(group):
                token = int(first[row])
                self._last[slot] = token
                self._host_len[slot] = len(request.prompt_ids)
                eos = token == self.program.eos_token_id
                finished = eos or request.max_new <= 1
                request._emit([] if eos else [token], finished)
                if finished:
                    self._retire(slot)
        self.stats["prefill_s"] += time.perf_counter() - t0

    def _build_prompt_inputs(self, group, bucket):
        batch = len(group)
        ids = np.zeros((batch, bucket), np.int64)
        for row, (_, request) in enumerate(group):
            ids[row, :len(request.prompt_ids)] = request.prompt_ids
        if self.program.mrope:
            positions = np.zeros((3, batch, bucket), np.int64)
            for row, (_, request) in enumerate(group):
                if request.positions is None:
                    raise ValueError("VL prompts need M-RoPE positions")
                t = request.positions.shape[1]
                positions[:, row, :t] = request.positions
                # pad-tail positions continue past the real ones (masked)
                positions[:, row, t:] = (request.positions.max()
                                         + 1 + np.arange(bucket - t))
        else:
            positions = np.broadcast_to(np.arange(bucket)[None],
                                        (batch, bucket)).copy()
        if any(request.embeds is not None for _, request in group):
            proto = next(r.embeds for _, r in group if r.embeds is not None)
            embeds = torch.zeros((batch, bucket, proto.shape[-1]),
                                 dtype=proto.dtype, device=self.device)
            for row, (_, request) in enumerate(group):
                if request.embeds is None:
                    raise ValueError("a prefill group mixes spliced and "
                                     "plain prompts")
                embeds[row, :request.embeds.shape[0]] = request.embeds
        else:
            embeds = self.program.embed_prompt(self._tensor(ids))
        return embeds, self._tensor(positions)

    # ── the serving loop ──────────────────────────────────────────
    def run(self, requests: Sequence[GenRequest]) -> list[list[int]]:
        """Drive all requests to completion; returns their token lists in
        order (EOS excluded). Requests stream through ``on_tokens`` as
        chunks complete."""
        eos = self.program.eos_token_id
        queue = deque(requests)
        while queue or self._slot_req:
            admitted = self._try_admit(queue)
            if admitted:
                self._prefill_admitted(admitted)
            if not self._slot_req:
                if queue:        # nothing admissible yet nothing running
                    raise RuntimeError(
                        "request needs more KV blocks than the pool has: "
                        f"{self._blocks_needed(queue[0])} > "
                        f"{self.n_blocks - 1}")
                break
            t0 = time.perf_counter()
            done0 = np.ones((self.n_slots,), bool)
            remaining = np.zeros((self.n_slots,), np.int32)
            for slot, request in self._slot_req.items():
                done0[slot] = False
                remaining[slot] = request.max_new - len(request.tokens)
            chunk = (self.chunk
                     if any(r.on_tokens is not None
                            for r in self._slot_req.values())
                     else self.throughput_chunk)
            tokens, last, _ = self.program.decode_chunk(
                self.cache, self._tensor(self._last), self._tensor(done0),
                self._tensor(remaining), self._tensor(self._rope_delta),
                chunk,
                table_pages=self._table_pages(self._slot_req, chunk + 1))
            tokens = tokens.cpu().numpy()
            self._last = last.cpu().numpy().astype(np.int32)
            self.stats["decode_s"] += time.perf_counter() - t0
            for slot in list(self._slot_req):
                request = self._slot_req[slot]
                fresh: list[int] = []
                finished = False
                budget = request.max_new - len(request.tokens)
                for token in tokens[slot]:
                    token = int(token)
                    if token == eos:
                        finished = True
                        break
                    fresh.append(token)
                    if len(fresh) >= budget:
                        finished = True
                        break
                request._emit(fresh, finished)
                self.stats["decode_tokens"] += len(fresh)
                if finished:
                    self._retire(slot)
            for slot in self._slot_req:
                # Survivors ran the full chunk (a chunk ends early only
                # when every slot is done, and done slots are retired).
                self._host_len[slot] += chunk
        return [request.tokens for request in requests]
