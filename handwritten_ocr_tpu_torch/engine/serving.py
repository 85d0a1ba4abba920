"""Continuous batching over the paged KV cache.

Port of ``handwritten_ocr_tpu/engine/serving.py``: a fixed set of S
decode slots steps together in chunks; at every chunk boundary the host
retires the sequences that hit EOS or their budget (freeing their blocks
at once) and admits queued requests into the freed slots.
``ContinuousBatcher.run_guided`` is the schema-guided counterpart: one
batched top-k step per committed token, and chunked greedy steps through
string value spans. Speculative decoding (``string_verify_round``,
``_verify_step``, off by default in the JAX package) is not ported.

Greedy argmax and the top-k run on fp32 logits on the device, and so do
the EOS, budget and quote stops; the host reads one flag per step to end
a chunk early, and the chunk's tokens (or the step's top-k) at its end.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pathlib
import time
import weakref
from collections import deque
from typing import Callable, Sequence

import numpy as np
import torch

from handwritten_ocr_tpu_torch.models.paged import PagedKVCache, paged_forward
from handwritten_ocr_tpu_torch.models.qwen25vl.language import lm_logits


_STOP_MASKS: "weakref.WeakKeyDictionary[object, dict[int, np.ndarray]]" = \
    weakref.WeakKeyDictionary()


def _string_stop_mask(tokenizer, vocab_size: int, eos: int) -> np.ndarray:
    """Bool[vocab]: the token's text contains a quote character (or it is
    EOS) — the device-side stall condition of chunked string spans. A '"'
    is a single byte, so byte-level BPE never splits it across tokens;
    the host still checks escape parity on the joint text. Built once per
    (tokenizer, vocab) and kept while the tokenizer lives."""
    try:
        per_vocab = _STOP_MASKS.setdefault(tokenizer, {})
    except TypeError:                       # not weak-referenceable
        per_vocab = {}
    cached = per_vocab.get(vocab_size)
    if cached is not None:
        return cached
    mask = _load_stop_mask(tokenizer, vocab_size)
    if mask is None:
        mask = np.zeros((vocab_size,), bool)
        # One decode_batch call of an HF fast tokenizer instead of
        # vocab_size Python decode() calls (seconds on 152k vocabs).
        backend = getattr(tokenizer, "_tokenizer", None)
        if backend is not None and hasattr(backend, "decode_batch"):
            texts = backend.decode_batch([[t] for t in range(vocab_size)],
                                         skip_special_tokens=False)
            for token, text in enumerate(texts):
                if '"' in text:
                    mask[token] = True
        else:
            for token in range(vocab_size):
                if '"' in tokenizer.decode([token]):
                    mask[token] = True
        _save_stop_mask(tokenizer, vocab_size, mask)
    mask = mask.copy()
    mask[eos] = True
    per_vocab[vocab_size] = mask
    return mask


def _stop_mask_path(tokenizer, vocab_size: int) -> pathlib.Path | None:
    """Cross-run cache file of the stop mask, keyed by the tokenizer's
    name_or_path (None when the tokenizer has no stable identity). The
    directory is the port's own, so the port and the JAX package never
    share a file."""
    name = str(getattr(tokenizer, "name_or_path", "") or "")
    if not name:
        return None
    digest = hashlib.sha256(f"{name}:{vocab_size}".encode()).hexdigest()[:16]
    root = os.path.join(os.path.expanduser("~"), ".cache",
                        "handwritten_ocr_tpu_torch")
    return pathlib.Path(root) / f"stop_mask_{digest}.npy"


def _load_stop_mask(tokenizer, vocab_size: int) -> np.ndarray | None:
    path = _stop_mask_path(tokenizer, vocab_size)
    if path is None or not path.exists():
        return None
    try:
        mask = np.load(path)
    except (OSError, ValueError):
        return None
    if mask.shape == (vocab_size,) and mask.dtype == bool:
        return mask
    return None


def _save_stop_mask(tokenizer, vocab_size: int, mask: np.ndarray) -> None:
    path = _stop_mask_path(tokenizer, vocab_size)
    if path is None:
        return
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp.npy")
        np.save(tmp, mask)
        tmp.replace(path)
    except OSError:
        pass


def topk_ids(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Ids [B, k] of the ``k`` largest of fp32 ``logits [B, V]``, value-
    descending and index-ascending on ties (``jax.lax.top_k``'s order;
    ``torch.topk`` gives ties in no order). Each logit becomes one unique
    int64 key, its order-preserving int32 image in the high half and
    V - 1 - index in the low half, so the top-k of the keys is exact; it
    all stays on the device."""
    vocab = logits.shape[-1]
    bits = logits.float().contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    low = vocab - 1 - torch.arange(vocab, device=logits.device)
    top = torch.topk(ordered * (1 << 32) + low, k, dim=-1).values
    return vocab - 1 - (top & 0xFFFFFFFF)


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

    def _prefill_logits(self, cache: PagedKVCache, embeds: torch.Tensor,
                        positions: torch.Tensor, true_len: torch.Tensor,
                        slot_ids: torch.Tensor) -> torch.Tensor:
        """Fresh prefill of right-padded prompts; fp32 logits [B, V] of
        each row's last real token."""
        start = torch.zeros_like(true_len)
        hidden = paged_forward(self.params, self.cfg, embeds, positions,
                               cache, slot_ids, start, true_len, fresh=True)
        rows = torch.arange(hidden.shape[0], device=hidden.device)
        last_hidden = hidden[rows, true_len.long() - 1][:, None]
        return lm_logits(self.params, self.cfg, last_hidden)[:, -1]

    def prefill(self, cache: PagedKVCache, embeds: torch.Tensor,
                positions: torch.Tensor, true_len: torch.Tensor,
                slot_ids: torch.Tensor) -> torch.Tensor:
        """Fresh prefill of right-padded prompts; returns each row's first
        generated token [B] (device int32)."""
        logits = self._prefill_logits(cache, embeds, positions, true_len,
                                      slot_ids)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def prefill_topk(self, cache: PagedKVCache, embeds: torch.Tensor,
                     positions: torch.Tensor, true_len: torch.Tensor, k: int,
                     slot_ids: torch.Tensor) -> torch.Tensor:
        """Prefill variant for guided decode: each row's next-token top-k
        ids [B, k] (device int64, :func:`topk_ids` order)."""
        return topk_ids(self._prefill_logits(cache, embeds, positions,
                                             true_len, slot_ids), k)

    def _step_logits(self, cache: PagedKVCache, slot_ids: torch.Tensor,
                     last: torch.Tensor, valid: torch.Tensor,
                     rope_delta: torch.Tensor, table_pages: int | None,
                     freeze: bool = False) -> torch.Tensor:
        """One decode step of every slot from its ``last`` token; fp32
        logits [S, V]. A slot that is not ``valid`` appends nothing and
        skips its attention; its length still advances by one unless
        ``freeze``."""
        start = cache.lengths.clone()
        pos = (start + rope_delta)[:, None]
        if self.mrope:
            pos = pos[None].expand(3, last.shape[0], 1)
        new_len = torch.where(valid, start + 1, start) if freeze else start + 1
        embeds = self.params["embed"]["w"][last.long()][:, None]
        hidden = paged_forward(self.params, self.cfg, embeds, pos, cache,
                               slot_ids, start, new_len, attn_valid=valid,
                               table_pages=table_pages)
        return lm_logits(self.params, self.cfg, hidden)[:, -1]

    def _step(self, cache: PagedKVCache, slot_ids: torch.Tensor,
              last: torch.Tensor, done: torch.Tensor,
              rope_delta: torch.Tensor,
              table_pages: int | None) -> torch.Tensor:
        """One greedy step for every slot: the next token [S] int32, EOS
        for a done slot (which appends nothing and skips its attention)."""
        logits = self._step_logits(cache, slot_ids, last, ~done, rope_delta,
                                   table_pages)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return torch.where(done, torch.full_like(nxt, self.eos_token_id), nxt)

    def step_topk(self, cache: PagedKVCache, last: torch.Tensor,
                  active: torch.Tensor, rope_delta: torch.Tensor, k: int,
                  table_pages: int | None = None) -> torch.Tensor:
        """One decode step for every slot returning each slot's top-k ids
        [S, k] — guided decode's device primitive: the host commits one
        token per slot (a forced scaffold token or a constrained choice).
        Inactive slots advance their (junk) length but append nothing and
        skip their attention; their top-k is never read."""
        slot_ids = torch.arange(last.shape[0], device=last.device)
        return topk_ids(self._step_logits(cache, slot_ids, last, active,
                                          rope_delta, table_pages), k)

    def string_chunk(self, cache: PagedKVCache, last: torch.Tensor,
                     auto: torch.Tensor, remaining: torch.Tensor,
                     stop_mask: torch.Tensor, rope_delta: torch.Tensor,
                     chunk: int, table_pages: int | None = None):
        """Free greedy decode of string value spans inside guided decode.

        Slots with ``auto`` advance greedily until they emit a token whose
        text holds a quote (``stop_mask``), emit EOS or exhaust
        ``remaining``; then they stall. Stalled and other slots are
        frozen: they append nothing and keep their length. The loop ends
        after ``chunk`` steps or when no slot is left to advance (one host
        read of a flag per step). Returns (tokens [S, chunk], EOS where a
        slot did not advance; last [S]; auto [S]; steps run)."""
        eos = self.eos_token_id
        n_slots = last.shape[0]
        slot_ids = torch.arange(n_slots, device=last.device)
        tokens = torch.full((n_slots, chunk), eos, dtype=torch.int32,
                            device=last.device)
        steps = 0
        for i in range(chunk):
            if not bool(auto.any()):
                break
            logits = self._step_logits(cache, slot_ids, last, auto,
                                       rope_delta, table_pages, freeze=True)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            last = torch.where(auto, nxt, last)
            tokens[:, i] = torch.where(auto, nxt, torch.full_like(nxt, eos))
            stall = stop_mask[nxt.long()] | (nxt == eos) | (i + 1 >= remaining)
            auto = auto & ~stall
            steps += 1
        return tokens, last, auto, steps

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
    prefill_bucket: prompt lengths pad up to a multiple of this; dtype:
    the fp pools' dtype; kv_quant: int8 pools with per-token, per-head
    scales instead (the serving default, ``config.SERVE_KV_INT8``).

    ``stats`` accumulates host-clock seconds of prefill and decode (each
    ends in a device-to-host read, so the times include the device work)
    and the tokens the decode chunks emitted; guided decode adds its
    top-k steps, string-chunk steps, committed tokens, the host seconds
    spent inside the schema sessions, and its sessions (complete or not).
    """

    # Prefill activations scale with rows x bucket tokens; cap the rows
    # per prefill call.
    PREFILL_GROUP_TOKENS = 32768

    def __init__(self, program: PagedProgram, *, n_slots: int = 8,
                 block_size: int = 64, n_blocks: int | None = None,
                 max_context: int = 4096, chunk: int = 16,
                 prefill_bucket: int = 128, dtype=torch.bfloat16,
                 device="cpu", throughput_chunk: int | None = None,
                 kv_quant: bool = False):
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
            dtype=dtype, device=self.device, kv_quant=kv_quant)
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
        self.stats = {"prefill_s": 0.0, "decode_s": 0.0, "decode_tokens": 0,
                      "topk_steps": 0, "string_steps": 0,
                      "guided_tokens": 0, "session_s": 0.0, "sessions": 0,
                      "sessions_complete": 0}

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

    def _check_fits(self, requests: Sequence[GenRequest]) -> None:
        """Raise at once when a request needs more blocks than the whole
        pool holds: it could never be admitted. Any other request waits
        in the queue until retiring requests free enough blocks."""
        for request in requests:
            need = self._blocks_needed(request)
            if need > self.n_blocks - 1:
                raise RuntimeError(
                    "request needs more KV blocks than the pool has: "
                    f"{need} > {self.n_blocks - 1}")

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

    # ── schema-guided serving (constrained decoding) ──────────────
    def run_guided(self, requests: Sequence[GenRequest], schema: dict,
                   tokenizer, top_k: int = 64) -> list[tuple[dict | None, bool]]:
        """Schema-constrained generation for every request (one shared
        schema: an agent batch shares its contract).

        Each committed token outside a string span is ONE batched
        ``step_topk``; the host commits one token per slot from the top-k
        under the schema state machine (``utils/schema_decode.py``):
        scaffold tokens are forced, values constrained by type. String
        value spans advance in chunked greedy steps (``string_chunk``).
        Returns per request ``(assembled object | None, complete)``;
        complete=False only when EOS or the budget came before a required
        field (callers fall back to the parse ladder). Each request's
        ``tokens`` receives every token committed to its context."""
        from handwritten_ocr_tpu_torch.utils.schema_decode import (
            SchemaSession, compile_schema)
        self._check_fits(requests)
        spec = compile_schema(schema)
        eos = self.program.eos_token_id
        stats = self.stats
        clock = time.perf_counter
        queue = deque(requests)
        sessions: dict[int, SchemaSession] = {}
        results: dict[int, tuple[dict | None, bool]] = {}
        stop_mask_host = _string_stop_mask(tokenizer,
                                           self.program.cfg.vocab_size, eos)
        stop_mask_dev = self._tensor(stop_mask_host)

        def in_session(fn, *args):
            """Call into a schema session, adding its host time to stats."""
            t0 = clock()
            try:
                return fn(*args)
            finally:
                stats["session_s"] += clock() - t0

        def commit(slot: int, token: int | None) -> None:
            if token is None:
                retire_slot(slot)
            else:
                self._last[slot] = token
                self._slot_req[slot].tokens.append(token)
                stats["guided_tokens"] += 1

        def admit() -> None:
            admitted = self._try_admit(queue)
            if not admitted:
                return
            t0 = clock()
            self.cache.block_tables.copy_(self._tensor(self._tables))
            for bucket, group in self._prefill_groups(admitted):
                slots = np.array([s for s, _ in group], np.int64)
                true_len = np.array([len(r.prompt_ids) for _, r in group],
                                    np.int32)
                embeds, positions = self._build_prompt_inputs(group, bucket)
                ids = self.program.prefill_topk(
                    self.cache, embeds, positions, self._tensor(true_len),
                    top_k, self._tensor(slots)).cpu().numpy()
                for row, (slot, request) in enumerate(group):
                    sessions[slot] = in_session(SchemaSession, spec, tokenizer,
                                                eos, request.max_new)
                    stats["sessions"] += 1
                    self._host_len[slot] = len(request.prompt_ids)
                    # Commit the first token now, establishing the loop
                    # invariant: _last committed but not yet embedded. A
                    # degenerate plan (a propertyless schema) finishes
                    # without generating anything.
                    commit(slot, in_session(sessions[slot].next_token,
                                            ids[row]))
            stats["prefill_s"] += clock() - t0

        def retire_slot(slot: int) -> None:
            request = self._slot_req[slot]
            results[id(request)] = result = sessions.pop(slot).result()
            stats["sessions_complete"] += int(result[1])
            self._retire(slot)
            self._last[slot] = eos

        def string_chunk_round() -> None:
            """Advance every session inside a string value span with the
            chunked device loop (up to ``chunk`` string tokens per in-span
            slot; other slots freeze) instead of per-token host guidance."""
            t0 = clock()
            auto = np.zeros((self.n_slots,), bool)
            remaining = np.zeros((self.n_slots,), np.int32)
            for slot, session in sessions.items():
                if session.in_string_span():
                    auto[slot] = True
                    remaining[slot] = max(session.budget, 0)
            tokens, last, _, steps = self.program.string_chunk(
                self.cache, self._tensor(self._last), self._tensor(auto),
                self._tensor(remaining), stop_mask_dev,
                self._tensor(self._rope_delta), self.chunk,
                # Width covers frozen sessions too.
                table_pages=self._table_pages(sessions, self.chunk + 1))
            tokens = tokens.cpu().numpy()
            self._last = last.cpu().numpy().astype(np.int32)
            stats["decode_s"] += clock() - t0
            stats["string_steps"] += steps
            for slot in list(sessions):
                if not auto[slot]:
                    continue
                row: list[int] = []
                for token in tokens[slot]:
                    token = int(token)
                    row.append(token)
                    if stop_mask_host[token] or token == eos:
                        break
                # The device advanced len(row), except when the budget
                # stalled it on a plain token and the trailing filler EOS
                # was also taken in: a +1 that only widens the table
                # bound, for a session that dies (budget spent) now.
                self._host_len[slot] += len(row)
                self._slot_req[slot].tokens.extend(row)
                stats["guided_tokens"] += len(row)
                in_session(sessions[slot].absorb_string_tokens, row)
                if sessions[slot].done:
                    retire_slot(slot)

        # Loop invariant at every round boundary: each active slot's
        # ``_last`` token is committed but NOT yet embedded or written;
        # both stepping disciplines (the top-k step and the string chunk)
        # start by embedding ``_last``, so they compose freely.
        while queue or sessions:
            admit()
            if not sessions:
                # Every admitted session finished at once; with every
                # block free again, the queue's head fits next round.
                continue
            # Drain string value spans; afterwards no session is mid-span
            # (a resolved span always refills the forced scaffold queue).
            while sessions and any(s.in_string_span()
                                   for s in sessions.values()):
                string_chunk_round()
            if queue and self._free_slots:
                admit()
            if not sessions:
                continue
            t0 = clock()
            active = np.zeros((self.n_slots,), bool)
            for slot in sessions:
                active[slot] = True
                self._host_len[slot] += 1
            ids = self.program.step_topk(
                self.cache, self._tensor(self._last), self._tensor(active),
                self._tensor(self._rope_delta), top_k,
                table_pages=self._table_pages(sessions, 2)).cpu().numpy()
            stats["decode_s"] += clock() - t0
            stats["topk_steps"] += 1
            for slot in list(sessions):
                # None: the session finished (or exhausted and drained).
                commit(slot, in_session(sessions[slot].next_token, ids[slot]))
        return [results[id(request)] for request in requests]

    # ── the serving loop ──────────────────────────────────────────
    def run(self, requests: Sequence[GenRequest]) -> list[list[int]]:
        """Drive all requests to completion; returns their token lists in
        order (EOS excluded). Requests stream through ``on_tokens`` as
        chunks complete."""
        self._check_fits(requests)
        eos = self.program.eos_token_id
        queue = deque(requests)
        while queue or self._slot_req:
            admitted = self._try_admit(queue)
            if admitted:
                self._prefill_admitted(admitted)
            if not self._slot_req:
                # Every admitted request finished in its prefill; with
                # every block free again, the queue's head fits next round.
                continue
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
