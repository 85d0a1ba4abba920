"""Continuous batching over the paged KV cache.

Port of ``handwritten_ocr_tpu/engine/serving.py``: a fixed set of S
decode slots steps together in chunks; at every chunk boundary the host
retires the sequences that hit EOS or their budget (freeing their blocks
at once) and admits queued requests into the freed slots.
``ContinuousBatcher.run_guided`` is the schema-guided counterpart: one
batched top-k step per committed token, and chunked greedy steps through
string value spans. Requests that ``speculate`` (prompt-lookup decoding,
off by default as in the JAX package) interleave verify rounds with both:
up to ``draft_k`` drafted tokens per slot scored in one forward, the
longest greedy-matching prefix accepted.

Greedy argmax and the top-k run on fp32 logits on the device, and so do
the EOS, budget and quote stops; the host reads one flag per step to end
a chunk early, and the chunk's tokens (or the step's top-k) at its end.
A plain chunk's greedy step and guided decode's string and top-k steps
read their inputs from the batcher's ``StepGraphs`` and step through it
(``engine/step_graph.py``): on one CUDA card (no tensor parallelism, no
FSDP) they are replayed from CUDA graphs, elsewhere run eagerly. Verify
steps run eagerly.

Under tensor parallelism (``PagedProgram(mesh=...)``) every rank of a
model group runs the same program on its slices: its pools hold its kv
heads, and its logits are its vocab shard, whose greedy ids and top-k
come from ``models/layers.py:topk_ids``'s merge over the group, so every
rank gets the same ids. The batcher's decisions (admission, EOS, budgets,
guided spans, drafts) are made on the host from those ids alone, so the
ranks take them alike and issue the same collectives in the same order.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pathlib
import tempfile
import time
import weakref
from collections import deque
from typing import Callable, Sequence

import numpy as np
import torch

from handwritten_ocr_tpu_torch.engine.step_graph import StepGraphs
from handwritten_ocr_tpu_torch.models.layers import (argmax_ids, embed,
                                                     group_size, topk_ids)
from handwritten_ocr_tpu_torch.models.paged import PagedKVCache, paged_forward
from handwritten_ocr_tpu_torch.models.qwen25vl.language import lm_logits
from handwritten_ocr_tpu_torch.parallel.mesh import model_group
from handwritten_ocr_tpu_torch.parallel.sharding import gathered
from handwritten_ocr_tpu_torch.trace import profile_span
from handwritten_ocr_tpu_torch.utils import schema_decode


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
    """Write the cache file through a temporary file of this process's
    own and a rename, so processes that build the same mask at once (the
    ranks of a group) never leave a torn file."""
    path = _stop_mask_path(tokenizer, vocab_size)
    if path is None:
        return
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.NamedTemporaryFile(dir=path.parent, suffix=".npy",
                                         delete=False) as handle:
            np.save(handle, mask)
        pathlib.Path(handle.name).replace(path)
    except OSError:
        pass


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
    # Prompt-lookup speculative decoding: draft the next tokens from the
    # last earlier occurrence of the current suffix n-gram in (prompt +
    # generated), score them all in ONE forward, accept the longest
    # prefix greedy decode would have produced. Greedy-invisible where the
    # verify forward and the decode step round alike (the CPU); on the
    # card the 17-token verify's products tile differently, so a
    # near-tie can flip.
    speculate: bool = False
    # Teacher-forced drafting (a measurement hook): drafts are read from
    # this token stream at the current generated offset instead of by
    # prompt lookup. Verify and accept are unchanged; only the drafts'
    # source differs, so acceptance can be controlled with random
    # weights, which never accept an n-gram draft. No engine sets it.
    draft_oracle: np.ndarray | None = None
    # Filled by the batcher:
    tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False

    def _emit(self, new_tokens: list[int], done: bool) -> None:
        self.tokens.extend(new_tokens)
        self.done = done
        if self.on_tokens is not None and (new_tokens or done):
            self.on_tokens(new_tokens, done)


def _ngram_draft(context: np.ndarray, k: int, max_n: int = 3,
                 min_n: int = 2) -> np.ndarray:
    """Prompt-lookup draft: the continuation after the LAST earlier
    occurrence of the current suffix n-gram (longest n first); at most
    ``k`` tokens, possibly none. Host numpy only."""
    length = len(context)
    for n in range(max_n, min_n - 1, -1):
        if length < n + 1:
            continue
        suffix = context[length - n:]
        windows = np.lib.stride_tricks.sliding_window_view(
            context[:length - 1], n)
        hits = np.nonzero((windows == suffix).all(axis=1))[0]
        if len(hits):
            i = int(hits[-1])
            cont = context[i + n: i + n + k]
            if len(cont):
                return cont.astype(np.int32)
    return np.empty(0, np.int32)


class PagedProgram:
    """Paged prefill + chunked greedy decode over one decoder stack.

    ``params`` is a text tree in the port's layout (embed / layers /
    final_norm / lm_head), e.g. a VL model's ``params["text"]``; with a
    ``mesh``, the rank's tensor-parallel slices of it, and every stage
    runs over the rank's "model" group. ``gather``: the tree's FSDP
    gather (``parallel/sharding.py:LayerGather``, None without FSDP).
    """

    def __init__(self, params: dict, cfg, *, eos_token_id: int | None = None,
                 mesh=None, gather=None):
        self.params = params
        self.cfg = cfg
        self.eos_token_id = (eos_token_id if eos_token_id is not None
                             else cfg.eos_token_id)
        self.mrope = getattr(cfg, "mrope_section", None) is not None
        self.mesh = mesh
        self.group = model_group(mesh)
        self.gather = gather
        # the kv heads this rank's pools hold
        self.kv_heads = cfg.num_key_value_heads // group_size(self.group)

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        return embed(gathered(self.gather, self.params["embed"], "embed"),
                     ids.long(), self.group)

    def _prefill_logits(self, cache: PagedKVCache, embeds: torch.Tensor,
                        positions: torch.Tensor, true_len: torch.Tensor,
                        slot_ids: torch.Tensor) -> torch.Tensor:
        """Fresh prefill of right-padded prompts; fp32 logits [B, V] of
        each row's last real token."""
        start = torch.zeros_like(true_len)
        hidden = paged_forward(self.params, self.cfg, embeds, positions,
                               cache, slot_ids, start, true_len, fresh=True,
                               group=self.group, gather=self.gather)
        rows = torch.arange(hidden.shape[0], device=hidden.device)
        last_hidden = hidden[rows, true_len.long() - 1][:, None]
        return lm_logits(self.params, self.cfg, last_hidden,
                         gather=self.gather)[:, -1]

    def prefill(self, cache: PagedKVCache, embeds: torch.Tensor,
                positions: torch.Tensor, true_len: torch.Tensor,
                slot_ids: torch.Tensor) -> torch.Tensor:
        """Fresh prefill of right-padded prompts; returns each row's first
        generated token [B] (device int32)."""
        logits = self._prefill_logits(cache, embeds, positions, true_len,
                                      slot_ids)
        return argmax_ids(logits, self.group)

    def prefill_topk(self, cache: PagedKVCache, embeds: torch.Tensor,
                     positions: torch.Tensor, true_len: torch.Tensor, k: int,
                     slot_ids: torch.Tensor) -> torch.Tensor:
        """Prefill variant for guided decode: each row's next-token top-k
        ids [B, k] (device int64, :func:`topk_ids` order)."""
        return topk_ids(self._prefill_logits(cache, embeds, positions,
                                             true_len, slot_ids), k,
                        self.group)

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
        hidden = paged_forward(self.params, self.cfg, self._embed(last)[:, None],
                               pos, cache, slot_ids, start, new_len,
                               attn_valid=valid, table_pages=table_pages,
                               group=self.group, gather=self.gather)
        return lm_logits(self.params, self.cfg, hidden,
                         gather=self.gather)[:, -1]

    def _step(self, cache: PagedKVCache, slot_ids: torch.Tensor,
              last: torch.Tensor, live: torch.Tensor,
              rope_delta: torch.Tensor,
              table_pages: int | None) -> torch.Tensor:
        """One greedy step for every slot: the next token [S] int32, EOS
        for a slot that is not ``live`` (a done slot, which appends
        nothing and skips its attention)."""
        logits = self._step_logits(cache, slot_ids, last, live, rope_delta,
                                   table_pages)
        nxt = argmax_ids(logits, self.group)
        return torch.where(live, nxt, torch.full_like(nxt, self.eos_token_id))

    def step_topk(self, cache: PagedKVCache, last: torch.Tensor,
                  active: torch.Tensor, rope_delta: torch.Tensor, k: int,
                  table_pages: int | None = None, *,
                  graphs: StepGraphs) -> torch.Tensor:
        """One decode step for every slot returning each slot's top-k ids
        [S, k] — guided decode's device primitive: the host commits one
        token per slot (a forced scaffold token or a constrained choice).
        Inactive slots advance their (junk) length but append nothing and
        skip their attention; their top-k is never read.

        ``graphs`` (the batcher's, over ``cache``): the step reads its
        buffers and steps through it (a replay of the graph of this ``k``,
        table width and rope path where it captures); the ids are a copy,
        which no later step overwrites."""
        _check_graphs(graphs, cache)
        graphs.load(last, rope_delta, active)
        ids = graphs.step(
            StepGraphs.key("topk", table_pages, k),
            lambda: topk_ids(self._step_logits(
                cache, graphs.slot_ids, graphs.last, graphs.live,
                graphs.rope_delta, table_pages), k, self.group))
        return ids.clone()

    def string_chunk(self, cache: PagedKVCache, last: torch.Tensor,
                     auto: torch.Tensor, remaining: torch.Tensor,
                     stop_mask: torch.Tensor, rope_delta: torch.Tensor,
                     chunk: int, table_pages: int | None = None, *,
                     graphs: StepGraphs):
        """Free greedy decode of string value spans inside guided decode.

        Slots with ``auto`` advance greedily until they emit a token whose
        text holds a quote (``stop_mask``), emit EOS or exhaust
        ``remaining``; then they stall. Stalled and other slots are
        frozen: they append nothing and keep their length. The loop ends
        after ``chunk`` steps or when no slot is left to advance (one host
        read of a flag per step). Returns (tokens [S, chunk], EOS where a
        slot did not advance; last [S]; auto [S]; steps run).

        ``graphs`` (the batcher's, over ``cache``): each step reads
        ``last`` and ``auto`` from its buffers and steps through it (a
        replay of the string step's graph of this table width and rope
        path where it captures); the stall test updates them in place."""
        eos = self.eos_token_id
        _check_graphs(graphs, cache)
        graphs.load(last, rope_delta, auto)
        last, auto = graphs.last, graphs.live
        key = StepGraphs.key("string", table_pages)
        tokens = torch.full((last.shape[0], chunk), eos, dtype=torch.int32,
                            device=last.device)

        def step():
            logits = self._step_logits(cache, graphs.slot_ids, last, auto,
                                       graphs.rope_delta, table_pages,
                                       freeze=True)
            return argmax_ids(logits, self.group)

        steps = 0
        for i in range(chunk):
            if not bool(auto.any()):
                break
            nxt = graphs.step(key, step)
            tokens[:, i] = torch.where(auto, nxt, torch.full_like(nxt, eos))
            stall = stop_mask[nxt.long()] | (nxt == eos) | (i + 1 >= remaining)
            last.copy_(torch.where(auto, nxt, last))
            auto &= ~stall
            steps += 1
        return tokens, last.clone(), auto.clone(), steps

    def verify_step(self, cache: PagedKVCache, last: torch.Tensor,
                    drafts: torch.Tensor, draft_len: torch.Tensor,
                    active: torch.Tensor, rope_delta: torch.Tensor,
                    table_pages: int | None = None):
        """Speculative verify: score ``[last, draft_0..draft_{K-1}]`` of
        every slot in one forward and accept the longest prefix of drafts
        that greedy decode would have produced; the tokens then equal K+1
        greedy steps over the accepted prefix plus the bonus token at the
        first divergence.

        drafts [S, K] int32 (junk beyond draft_len[s]); active [S] marks
        the slots whose drafts and outputs are real. Token i of a slot is
        real for i <= draft_len (0 is the committed ``last``): only those
        are appended and attend. Lengths become start + 1 + accepted
        (capped at the table) for active slots, and stay for the others;
        the rejected positions hold rows that later steps overwrite
        before they read them. Returns (tokens [S, K+1] int32, accepted
        [S]) on the device."""
        n_slots, k = drafts.shape
        steps = torch.arange(k + 1, device=last.device)
        slot_ids = torch.arange(n_slots, device=last.device)
        in_tokens = torch.cat([last[:, None], drafts], dim=1)
        embeds = self._embed(in_tokens)
        start = cache.lengths.clone()
        pos = (start + rope_delta)[:, None] + steps[None]
        if self.mrope:
            pos = pos[None].expand(3, n_slots, k + 1)
        token_valid = active[:, None] & (steps[None] <= draft_len[:, None])
        hidden = paged_forward(self.params, self.cfg, embeds, pos, cache,
                               slot_ids, start, start,    # lengths set below
                               attn_valid=token_valid, table_pages=table_pages,
                               group=self.group, gather=self.gather)
        logits = lm_logits(self.params, self.cfg, hidden, gather=self.gather)
        nxt = argmax_ids(logits, self.group)
        match = (nxt[:, :k] == drafts) & (steps[None, :k] < draft_len[:, None])
        accepted = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
        new_len = torch.clamp(start + 1 + accepted, max=cache.max_context)
        cache.lengths.copy_(torch.where(active, new_len, start))
        return nxt, accepted

    def decode_chunk(self, cache: PagedKVCache, last: torch.Tensor,
                     done: torch.Tensor, remaining: torch.Tensor,
                     rope_delta: torch.Tensor, chunk: int,
                     table_pages: int | None = None, *,
                     graphs: StepGraphs):
        """Up to ``chunk`` greedy steps for every slot; a done slot emits
        EOS and skips its attention. Ends early once every slot is done.
        Returns (tokens [S, chunk], last [S], done [S]) on the device.

        ``graphs`` (the batcher's, over ``cache``): each step reads
        ``last`` and the live slots (not ``done``) from its buffers, which
        the loop updates in place, and steps through it (a replay of the
        greedy step's graph of this table width and rope path where it
        captures, ``engine/step_graph.py``).

        Host spans (``trace.profile_span``): ``decode.sync`` around each
        flag read, ``decode.step`` around each step's enqueue (the step,
        the token write and the live-slot update)."""
        eos = self.eos_token_id
        _check_graphs(graphs, cache)
        graphs.load(last, rope_delta, ~done)
        last, live = graphs.last, graphs.live
        key = StepGraphs.key("greedy", table_pages)
        tokens = torch.full((last.shape[0], chunk), eos, dtype=torch.int32,
                            device=last.device)
        for i in range(chunk):
            with profile_span("decode.sync"):
                finished = not bool(live.any())
            if finished:
                break
            with profile_span("decode.step"):
                nxt = graphs.step(key, lambda: self._step(
                    cache, graphs.slot_ids, last, live, graphs.rope_delta,
                    table_pages))
                tokens[:, i] = nxt
                live &= (nxt != eos) & (remaining > i + 1)
                last.copy_(nxt)
        return tokens, last.clone(), ~live

    def embed_prompt(self, ids: torch.Tensor) -> torch.Tensor:
        """Default prompt embedding (no vision splice): table lookup."""
        return self._embed(ids)


def _check_graphs(graphs: StepGraphs, cache: PagedKVCache) -> None:
    if graphs.cache is not cache:
        raise ValueError("the step graphs belong to another cache")


@dataclasses.dataclass
class _Guided:
    """One ``run_guided`` call: its compiled schema, tokenizer and top-k,
    the string spans' stop mask (on the host and on the device), each live
    slot's schema session, and each finished request's result by its id."""

    spec: object
    tokenizer: object
    top_k: int
    stop: np.ndarray
    stop_dev: torch.Tensor
    sessions: dict = dataclasses.field(default_factory=dict)
    results: dict = dataclasses.field(default_factory=dict)


class ContinuousBatcher:
    """Slot/block scheduler driving a :class:`PagedProgram`.

    n_slots: decode batch width; block_size: KV block granularity (tokens);
    n_blocks: pool size (block 0 is the trash sink); max_context: per-
    sequence bound (table width); chunk: decode steps per dispatch when a
    live request streams tokens, throughput_chunk otherwise;
    prefill_bucket: prompt lengths pad up to a multiple of this;
    draft_k: tokens drafted per slot for a speculative verify round;
    dtype: the fp pools' dtype; kv_quant: int8 pools with per-token,
    per-head scales instead (the serving default, ``config.SERVE_KV_INT8``).

    ``stats`` accumulates host-clock seconds of prefill and decode (each
    ends in a device-to-host read, so the times include the device work),
    the tokens the decode chunks emitted, the steps they ran
    (``decode_steps``: each chunk's longest-running slot's) and the steps
    their slots ran live (``decode_slot_steps``: each slot's tokens and
    its EOS step), and of those the steps replayed from a CUDA graph
    (``decode_graph_steps``) and the graphs captured
    (``decode_graph_captures``: one eager step each); guided decode adds
    its top-k steps, string-chunk steps, the steps of both replayed from
    a CUDA graph and their graphs (``guided_graph_steps``,
    ``guided_graph_captures``), committed tokens, the host seconds spent
    inside the schema sessions, and its sessions (complete or not);
    verify rounds add their seconds and the tokens they committed.
    ``spec_stats`` counts the verify rounds and the tokens drafted and
    accepted, as the JAX batcher does.
    """

    # Prefill activations scale with rows x bucket tokens; cap the rows
    # per prefill call.
    PREFILL_GROUP_TOKENS = 32768

    def __init__(self, program: PagedProgram, *, n_slots: int = 8,
                 block_size: int = 64, n_blocks: int | None = None,
                 max_context: int = 4096, chunk: int = 16,
                 prefill_bucket: int = 128, draft_k: int = 16,
                 dtype=torch.bfloat16, device="cpu",
                 throughput_chunk: int | None = None,
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
            self.max_blocks, program.kv_heads, cfg.head_dim,
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
        # Speculative decoding: draft_k tokens drafted per verify round; a
        # round that averaged under 2 accepted tokens a slot is followed
        # by one plain dispatch, so inputs that never match pay little.
        self.draft_k = draft_k
        self._spec_cooldown = 0
        self.spec_stats = {"rounds": 0, "drafted": 0, "accepted": 0}
        self.stats = {"prefill_s": 0.0, "decode_s": 0.0, "decode_tokens": 0,
                      "topk_steps": 0, "string_steps": 0,
                      "guided_tokens": 0, "session_s": 0.0, "sessions": 0,
                      "sessions_complete": 0, "verify_s": 0.0,
                      "verify_tokens": 0, "decode_steps": 0,
                      "decode_slot_steps": 0, "decode_graph_steps": 0,
                      "decode_graph_captures": 0, "guided_graph_steps": 0,
                      "guided_graph_captures": 0}
        # The decode steps' buffers over this batcher's cache, and their
        # CUDA graphs where the program allows them; they go with the
        # batcher.
        self._graphs = StepGraphs(program, self.cache, self.stats)

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

    def _prefill(self, admitted: list[tuple[int, GenRequest]], head,
                 take) -> None:
        """Upload the block tables and prefill ``admitted`` in its bucket
        groups: ``head(embeds, positions, true_len, slot_ids)`` calls the
        program's prefill unit, whose rows are read on the host, and
        ``take(slot, request, row)`` takes in each row once the slot's
        length is set. ``prefill_s`` counts all of it."""
        t0 = time.perf_counter()
        self.cache.block_tables.copy_(self._tensor(self._tables))
        for bucket, group in self._prefill_groups(admitted):
            slots = np.array([s for s, _ in group], np.int64)
            true_len = np.array([len(r.prompt_ids) for _, r in group], np.int32)
            embeds, positions = self._build_prompt_inputs(group, bucket)
            out = head(embeds, positions, self._tensor(true_len),
                       self._tensor(slots)).cpu().numpy()
            for row, (slot, request) in enumerate(group):
                self._host_len[slot] = len(request.prompt_ids)
                take(slot, request, out[row])
        self.stats["prefill_s"] += time.perf_counter() - t0

    def _prefill_admitted(self, admitted: list[tuple[int, GenRequest]]) -> None:
        """``run``'s prefill: each row's first token is committed and
        emitted (its EOS, or a budget of one, retires the slot)."""
        def first(slot, request, token):
            self._last[slot] = int(token)
            self._emit_row(slot, [token])
        self._prefill(admitted, lambda *inputs: self.program.prefill(
            self.cache, *inputs), first)

    def _emit_row(self, slot: int, row) -> tuple[int, bool]:
        """Emit ``row``'s tokens to the slot's request up to its EOS or the
        end of its budget, retiring the slot when either comes; returns
        (the tokens emitted, whether EOS came)."""
        request = self._slot_req[slot]
        budget = request.max_new - len(request.tokens)
        fresh: list[int] = []
        finished = by_eos = False
        for token in row:
            token = int(token)
            if token == self.program.eos_token_id:
                finished = by_eos = True
                break
            fresh.append(token)
            if len(fresh) >= budget:
                finished = True
                break
        request._emit(fresh, finished)
        if finished:
            self._retire(slot)
        return len(fresh), by_eos

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
        self._check_fits(requests)
        stop = _string_stop_mask(tokenizer, self.program.cfg.vocab_size,
                                 self.program.eos_token_id)
        g = _Guided(schema_decode.compile_schema(schema), tokenizer, top_k,
                    stop, self._tensor(stop))
        queue = deque(requests)
        # Loop invariant at every round boundary: each active slot's
        # ``_last`` token is committed but NOT yet embedded or written;
        # both stepping disciplines (the top-k step and the string chunk)
        # start by embedding ``_last``, so they compose freely.
        while queue or g.sessions:
            self._open_sessions(g, queue)
            if not g.sessions:
                # Every admitted session finished at once; with every
                # block free again, the queue's head fits next round.
                continue
            # Drain string value spans: verify rounds while the drafts
            # justify them (an editor's ``corrected_text`` copies its
            # prompt almost verbatim), else the chunked loop. Afterwards no
            # session is mid-span (a resolved span refills the scaffold
            # queue).
            while any(s.in_string_span() for s in g.sessions.values()):
                spec = self._spec_drafts(
                    {slot: session.budget for slot, session
                     in g.sessions.items() if session.in_string_span()},
                    g.stop)
                if spec is None:
                    self._string_chunk_round(g)
                else:
                    self._verify_round(*spec, lambda slot, row:
                                       self._absorb(g, slot, row))
            self._open_sessions(g, queue)
            if g.sessions:
                self._topk_round(g)
        return [g.results[id(request)] for request in requests]

    def _open_sessions(self, g: _Guided, queue: deque) -> None:
        """Admit what fits from ``queue`` and prefill it: each row opens a
        schema session and commits its first token, which establishes
        ``run_guided``'s loop invariant. A degenerate plan (a propertyless
        schema) finishes without generating anything."""
        admitted = self._try_admit(queue)
        if not admitted:
            return

        def open_session(slot, request, ids):
            session = g.sessions[slot] = self._in_session(
                schema_decode.SchemaSession, g.spec, g.tokenizer,
                self.program.eos_token_id, request.max_new)
            self.stats["sessions"] += 1
            self._commit(g, slot, self._in_session(session.next_token, ids))
        self._prefill(admitted, lambda embeds, positions, true_len, slots:
                      self.program.prefill_topk(self.cache, embeds, positions,
                                                true_len, g.top_k, slots),
                      open_session)

    def _in_session(self, fn, *args):
        """Call into a schema session, adding its host time to stats."""
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self.stats["session_s"] += time.perf_counter() - t0

    def _commit(self, g: _Guided, slot: int, token: int | None) -> None:
        """Commit a session's next token (None: the session finished)."""
        if token is None:
            self._end_session(g, slot)
        else:
            self._last[slot] = token
            self._slot_req[slot].tokens.append(token)
            self.stats["guided_tokens"] += 1

    def _end_session(self, g: _Guided, slot: int) -> None:
        request = self._slot_req[slot]
        g.results[id(request)] = result = g.sessions.pop(slot).result()
        self.stats["sessions_complete"] += int(result[1])
        self._retire(slot)
        self._last[slot] = self.program.eos_token_id

    def _absorb(self, g: _Guided, slot: int, row: list[int]) -> int:
        """Take a string span's tokens into the slot's request and session,
        ending the session when it is done; returns how many."""
        self._slot_req[slot].tokens.extend(row)
        self.stats["guided_tokens"] += len(row)
        self._in_session(g.sessions[slot].absorb_string_tokens, row)
        if g.sessions[slot].done:
            self._end_session(g, slot)
        return len(row)

    def _string_chunk_round(self, g: _Guided) -> None:
        """Advance every session inside a string value span with the
        chunked device loop (up to ``chunk`` string tokens per in-span
        slot; other slots freeze) instead of per-token host guidance."""
        t0 = time.perf_counter()
        auto = np.zeros((self.n_slots,), bool)
        remaining = np.zeros((self.n_slots,), np.int32)
        for slot, session in g.sessions.items():
            if session.in_string_span():
                auto[slot] = True
                remaining[slot] = max(session.budget, 0)
        tokens, last, _, steps = self.program.string_chunk(
            self.cache, self._tensor(self._last), self._tensor(auto),
            self._tensor(remaining), g.stop_dev,
            self._tensor(self._rope_delta), self.chunk,
            # Width covers frozen sessions too.
            table_pages=self._table_pages(g.sessions, self.chunk + 1),
            graphs=self._graphs)
        tokens = tokens.cpu().numpy()
        self._last = last.cpu().numpy().astype(np.int32)
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["string_steps"] += steps
        for slot in list(g.sessions):
            if not auto[slot]:
                continue
            row: list[int] = []
            for token in tokens[slot]:
                token = int(token)
                row.append(token)
                if g.stop[token] or token == self.program.eos_token_id:
                    break
            # The device advanced len(row), except when the budget
            # stalled it on a plain token and the trailing filler EOS
            # was also taken in: a +1 that only widens the table
            # bound, for a session that dies (budget spent) now.
            self._host_len[slot] += len(row)
            self._absorb(g, slot, row)

    def _topk_round(self, g: _Guided) -> None:
        """One batched top-k step: every session commits one token from
        its slot's top-k."""
        t0 = time.perf_counter()
        active = np.zeros((self.n_slots,), bool)
        for slot in g.sessions:
            active[slot] = True
            self._host_len[slot] += 1
        ids = self.program.step_topk(
            self.cache, self._tensor(self._last), self._tensor(active),
            self._tensor(self._rope_delta), g.top_k,
            table_pages=self._table_pages(g.sessions, 2),
            graphs=self._graphs).cpu().numpy()
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["topk_steps"] += 1
        for slot in list(g.sessions):
            # None: the session finished (or exhausted and drained).
            self._commit(g, slot, self._in_session(g.sessions[slot].next_token,
                                                   ids[slot]))

    # ── speculative decoding (prompt-lookup drafting) ─────────────
    def _count_round(self, draft_len: np.ndarray, accepted: int,
                     live: int) -> None:
        """Count a verify round; after one that averaged under 2 accepted
        tokens a slot, the next dispatch is a plain one."""
        self.spec_stats["rounds"] += 1
        self.spec_stats["drafted"] += int(draft_len.sum())
        self.spec_stats["accepted"] += accepted
        if live and accepted / live < 2.0:
            self._spec_cooldown = 1

    def _spec_drafts(self, budgets: dict[int, int],
                     stop: np.ndarray | None = None):
        """Drafts for a verify round over the slots of ``budgets`` (slot ->
        the tokens it may still commit, in the order the round takes them
        in): (drafts [S, draft_k], draft_len [S], the slots that take
        part), or None when a plain dispatch is the better one: a cooldown
        is on, none of the slots speculates, or fewer than half of them
        drafted two tokens or more (a verify round advances a slot without
        a draft by one token, where a plain dispatch advances it by a
        chunk).

        Without ``stop`` (plain decode) every slot takes part. With it
        (guided decode's string spans) each draft is cut at its first stop
        token, and only the slots left with two tokens or more take part."""
        if self._spec_cooldown > 0:
            self._spec_cooldown -= 1
            return None
        speculating = [slot for slot in budgets
                       if self._slot_req[slot].speculate]
        if not speculating:
            return None
        drafts = np.zeros((self.n_slots, self.draft_k), np.int32)
        draft_len = np.zeros((self.n_slots,), np.int32)
        for slot in speculating:
            request = self._slot_req[slot]
            cap = min(self.draft_k, budgets[slot] - 1)
            if cap <= 0:
                continue
            if request.draft_oracle is not None:
                pos = len(request.tokens)
                draft = np.asarray(request.draft_oracle[pos:pos + cap],
                                   np.int32)
            else:
                draft = _ngram_draft(np.concatenate([
                    np.asarray(request.prompt_ids, np.int32),
                    np.asarray(request.tokens, np.int32)]), cap)
            if stop is not None:
                stop_at = next((i for i, t in enumerate(draft) if stop[t]),
                               len(draft))
                draft = draft[:stop_at]
                if len(draft) < 2:
                    continue
            drafts[slot, :len(draft)] = draft
            draft_len[slot] = len(draft)
        good = int((draft_len >= 2).sum())
        if good * 2 < len(budgets) or good == 0:
            return None
        if stop is None:
            return drafts, draft_len, list(budgets)
        return drafts, draft_len, [slot for slot in budgets if draft_len[slot]]

    def _verify_round(self, drafts: np.ndarray, draft_len: np.ndarray,
                      slots: list[int], take) -> None:
        """One verify forward (``_spec_drafts``' round): each of ``slots``
        takes its longest greedy-matching draft prefix and the bonus token.
        ``take(slot, emitted)`` takes them in, once the slot's length and
        last token are set, and returns how many it committed."""
        t0 = time.perf_counter()
        active = np.zeros((self.n_slots,), bool)
        active[slots] = True
        tokens, accepted = self.program.verify_step(
            self.cache, self._tensor(self._last), self._tensor(drafts),
            self._tensor(draft_len), self._tensor(active),
            self._tensor(self._rope_delta),
            table_pages=self._table_pages(self._slot_req, self.draft_k + 2))
        tokens = tokens.cpu().numpy()
        accepted = accepted.cpu().numpy()
        self.stats["verify_s"] += time.perf_counter() - t0
        total = 0
        for slot in slots:
            n_acc = int(accepted[slot])
            total += n_acc
            emitted = [int(t) for t in tokens[slot, :n_acc + 1]]
            self._host_len[slot] += 1 + n_acc       # the rows written
            self._last[slot] = emitted[-1]          # committed, not embedded
            self.stats["verify_tokens"] += take(slot, emitted)
        self._count_round(draft_len, total, len(slots))

    # ── the serving loop ──────────────────────────────────────────
    def run(self, requests: Sequence[GenRequest]) -> list[list[int]]:
        """Drive all requests to completion; returns their token lists in
        order (EOS excluded). Requests stream through ``on_tokens`` as
        chunks complete. Requests that ``speculate`` interleave verify
        rounds with the plain decode chunks."""
        self._check_fits(requests)
        queue = deque(requests)
        while queue or self._slot_req:
            admitted = self._try_admit(queue)
            if admitted:
                self._prefill_admitted(admitted)
            if not self._slot_req:
                # Every admitted request finished in its prefill; with
                # every block free again, the queue's head fits next round.
                continue
            spec = self._spec_drafts({slot: r.max_new - len(r.tokens)
                                      for slot, r in self._slot_req.items()})
            if spec is not None:
                self._verify_round(*spec, lambda slot, row:
                                   self._emit_row(slot, row)[0])
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
                table_pages=self._table_pages(self._slot_req, chunk + 1),
                graphs=self._graphs)
            with profile_span("decode.sync"):
                tokens = tokens.cpu().numpy()
                self._last = last.cpu().numpy().astype(np.int32)
            self.stats["decode_s"] += time.perf_counter() - t0
            longest = 0
            for slot in list(self._slot_req):
                fresh, by_eos = self._emit_row(slot, tokens[slot])
                self.stats["decode_tokens"] += fresh
                # The steps the slot ran live: its tokens and the step
                # that emitted its EOS.
                ran = fresh + by_eos
                self.stats["decode_slot_steps"] += ran
                longest = max(longest, ran)
            self.stats["decode_steps"] += longest
            for slot in self._slot_req:
                # Survivors ran the full chunk (a chunk ends early only
                # when every slot is done, and done slots are retired).
                self._host_len[slot] += chunk
        return [request.tokens for request in requests]
