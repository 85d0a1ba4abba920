"""Operations and bytes of the work a window did, from the cell's shapes
and live contexts, never from a kernel's launch configuration: the same
count whatever implements the layer. Each input byte is read once and
each output byte written once.

``Work`` gathers the counts of one window: the reads prefilled
(prompt lengths), the reads encoded by the vision tower (grids), and
every decode-shaped step (the live slots and each one's context after
the step's new token). The functions below turn them into FLOPs and
bytes. The decode-step floor is copied from ``chip_smoke.py:1395-1404``
(``phase_reasoning``: every weight read once, the embedding being a row
gather, plus the live slots' int8 KV window) and ``bench.py:140``
(``decode_step_read_bytes``).
"""

from __future__ import annotations

import dataclasses

BF16 = 2


@dataclasses.dataclass
class Work:
    prompts: list[int] = dataclasses.field(default_factory=list)
    grids: list[tuple[int, int, int]] = dataclasses.field(default_factory=list)
    # one (live slots, sum of their contexts) per decode-shaped step
    steps: list[tuple[int, int]] = dataclasses.field(default_factory=list)
    frozen: bool = False        # no more counting: the trace has stopped

    def step(self, contexts) -> None:
        contexts = [int(c) for c in contexts]
        if contexts:
            self.steps.append((len(contexts), sum(contexts)))

    @property
    def live(self) -> int:
        return sum(n for n, _ in self.steps)

    @property
    def context(self) -> int:
        return sum(c for _, c in self.steps)


# ── the decoder ─────────────────────────────────────────────────────

def layer_params(t) -> int:
    """Projection parameters of one decoder layer."""
    d, hd = t.hidden_size, t.head_dim
    return (d * t.num_attention_heads * hd + 2 * d * t.num_key_value_heads * hd
            + t.num_attention_heads * hd * d + 3 * d * t.intermediate_size)


def decode_weight_bytes(t) -> int:
    """Every projection and the lm_head read once in bf16 (the embedding
    is a row gather)."""
    return (t.num_hidden_layers * layer_params(t)
            + t.vocab_size * t.hidden_size) * BF16


def kv_bytes_per_token(t) -> int:
    """int8 K and V of one token over every layer, with an fp32 scale per
    kv head."""
    return 2 * t.num_hidden_layers * t.num_key_value_heads * (t.head_dim + 4)


def decode_flops(t, work: Work) -> float:
    """Products of the live rows (projections and head) and attention
    over each live context."""
    per_row = 2 * (t.num_hidden_layers * layer_params(t)
                   + t.vocab_size * t.hidden_size)
    attention = 4 * t.num_hidden_layers * t.num_attention_heads * t.head_dim
    return per_row * work.live + attention * work.context


def decode_floor_seconds(t, work: Work, bandwidth: float) -> float:
    """The least time of the window's decode steps: each reads every
    weight once and its live slots' int8 KV."""
    return (len(work.steps) * decode_weight_bytes(t)
            + work.context * kv_bytes_per_token(t)) / bandwidth


def paged_attention(t, work: Work) -> tuple[float, float]:
    """(FLOPs, bytes) of decode attention: each live slot's int8 K/V
    window read once, its query read and its output written in bf16."""
    layers, hq, hd = t.num_hidden_layers, t.num_attention_heads, t.head_dim
    flops = 4 * layers * hq * hd * work.context
    n_bytes = layers * (work.context * t.num_key_value_heads * (hd + 4) * 2
                        + work.live * 2 * hq * hd * BF16)
    return flops, n_bytes


def prefill_flops(t, prompt: int) -> float:
    """A prompt's prefill: every projection per token, causal attention
    and the head for its last token."""
    causal = prompt * (prompt + 1) // 2
    return (2 * prompt * t.num_hidden_layers * layer_params(t)
            + 4 * t.num_hidden_layers * t.num_attention_heads * t.head_dim * causal
            + 2 * t.vocab_size * t.hidden_size)


def flash_prefill(t, prompt: int) -> tuple[float, float]:
    """(FLOPs, bytes) of a prompt's causal attention over its layers."""
    hq, hkv, hd = t.num_attention_heads, t.num_key_value_heads, t.head_dim
    causal = prompt * (prompt + 1) // 2
    flops = 4 * t.num_hidden_layers * hq * hd * causal
    n_bytes = t.num_hidden_layers * prompt * hd * BF16 * (2 * hq + 2 * hkv)
    return flops, n_bytes


# ── the vision tower ────────────────────────────────────────────────

def windows(v, grid) -> list[int]:
    """Tokens of each attention window of a grid (4x4 cells of 2x2
    patches at the published window size; edge windows smaller)."""
    t, h, w = grid
    merge = v.spatial_merge_size
    win = v.window_size // merge // v.patch_size
    ch, cw = h // merge, w // merge
    sizes = []
    for _ in range(t):
        for r in range(0, ch, win):
            for c in range(0, cw, win):
                sizes.append(min(win, ch - r) * min(win, cw - c)
                             * merge * merge)
    return sizes


def vision_flops(v, grid) -> float:
    t, h, w = grid
    p, d = t * h * w, v.hidden_size
    patch_dim = v.in_channels * v.temporal_patch_size * v.patch_size ** 2
    n_full = len(v.fullatt_block_indexes)
    per_block = 2 * p * (3 * d * d + d * d + 3 * d * v.intermediate_size)
    window_sq = sum(n * n for n in windows(v, grid))
    attention = 4 * d * (n_full * p * p + (v.depth - n_full) * window_sq)
    merged = d * v.spatial_merge_size ** 2
    cells = p // v.spatial_merge_size ** 2
    merger = 2 * cells * (merged * merged + merged * v.out_hidden_size)
    return 2 * p * patch_dim * d + v.depth * per_block + attention + merger


def flash_vision(v, grid) -> tuple[float, float]:
    """(FLOPs, bytes) of the global blocks' attention of one image."""
    t, h, w = grid
    p, d = t * h * w, v.hidden_size
    n_full = len(v.fullatt_block_indexes)
    return n_full * 4 * d * p * p, n_full * 4 * p * d * BF16


def window_attention(v, grid) -> tuple[float, float]:
    """(FLOPs, bytes) of the windowed blocks' attention of one image: the
    packed qkv read and the output written in bf16, and the fp32 rotary
    tables read."""
    t, h, w = grid
    p, d = t * h * w, v.hidden_size
    hd = d // v.num_heads
    n_win = v.depth - len(v.fullatt_block_indexes)
    flops = n_win * 4 * d * sum(n * n for n in windows(v, grid))
    n_bytes = n_win * (p * 4 * d * BF16 + 2 * p * hd * 4)
    return flops, n_bytes


def model_flops(cfg, work: Work) -> float:
    """Every model FLOP of the window's work: the vision tower of each
    read encoded, each prompt's prefill, each decode step."""
    t = cfg.text
    return (sum(prefill_flops(t, n) for n in work.prompts)
            + decode_flops(t, work)
            + sum(vision_flops(cfg.vision, g) for g in work.grids))
