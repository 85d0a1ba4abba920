"""The whole model's share of the card's bf16 peak over the traced
window, %: every model FLOP of the window's guided decode (each prompt's
prefill, each step's live rows and their attention) over the window's
length times 989 TFLOP/s."""

from benchmark.peaks import BF16_FLOPS_PER_S
from benchmark.work import decode_flops, prefill_flops


def read(m):
    if m.summary is None:
        return None
    flops = sum(prefill_flops(m.text, n) for n in m.work.prompts) \
        + decode_flops(m.text, m.work)
    return flops / (m.window_s * BF16_FLOPS_PER_S) * 100 if flops else None
