"""Operations and bytes of the int8-weight products (kernel #5,
``csrc/int8_matmul.cu``) in a window of guided decode, from the model's
shapes and the window's live rows; whatever runs them, as ``work.py``
counts the rest.

The port sends a product with at most 32 rows to the kernel
(``models/layers.py:_quantized_matmul``, ``language.py:lm_logits``): at
each decode-shaped step every projection of every layer and the lm_head,
and at each prefill call the lm_head over the call's last-token rows
(its projections run as dequantised products). A product of ``rows``
live rows, ``n_in`` inputs and ``n_out`` outputs reads its int8 weight
once (1 byte each), its fp32 scales (4 bytes an output) and its bf16
rows, and writes its outputs (bf16; the lm_head's in fp32), with
``2 rows n_in n_out`` operations.
"""

from __future__ import annotations

from benchmark.peaks import least_seconds
from benchmark.work import BF16, Work

FP32 = 4


def projections(t) -> list[tuple[int, int]]:
    """(n_in, n_out) of every int8 projection of one decoder layer."""
    d, hd = t.hidden_size, t.head_dim
    q, kv = t.num_attention_heads * hd, t.num_key_value_heads * hd
    inter = t.intermediate_size
    return [(d, q), (d, kv), (d, kv), (q, d),
            (d, inter), (d, inter), (inter, d)]


def product(rows: int, n_in: int, n_out: int,
            out_bytes: int = BF16) -> tuple[float, float]:
    """(FLOPs, bytes) of one int8-weight product."""
    flops = 2 * rows * n_in * n_out
    n_bytes = n_in * n_out + FP32 * n_out + rows * (BF16 * n_in
                                                    + out_bytes * n_out)
    return flops, n_bytes


def head(t, rows: int) -> tuple[float, float]:
    return product(rows, t.hidden_size, t.vocab_size, FP32)


def step(t, rows: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one decode-shaped step's int8 products."""
    flops, n_bytes = head(t, rows)
    for n_in, n_out in projections(t):
        f, b = product(rows, n_in, n_out)
        flops += t.num_hidden_layers * f
        n_bytes += t.num_hidden_layers * b
    return flops, n_bytes


def least_seconds_int8(t, work: Work, prefill_calls: int) -> float:
    """The least time of the window's int8 products at the published
    peaks: each decode-shaped step on its own, and the prefill calls'
    lm_heads together (their rows are ``len(work.prompts)``; taken
    together, the bound can only be lower than the calls' sum)."""
    total = sum(least_seconds(*step(t, live)) for live, _ in work.steps)
    if prefill_calls:
        flops, n_bytes = head(t, len(work.prompts))
        weight = t.hidden_size * t.vocab_size + FP32 * t.vocab_size
        total += least_seconds(flops, n_bytes + (prefill_calls - 1) * weight)
    return total
