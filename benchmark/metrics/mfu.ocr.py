"""The whole model's share of the card's bf16 peak over the traced
window, %: every model FLOP of the window's work (vision tower of each
read encoded, each prompt's prefill, each decode step's live rows and
attention) over the window's length times 989 TFLOP/s."""

from benchmark.peaks import BF16_FLOPS_PER_S
from benchmark.work import model_flops


def read(m):
    if m.summary is None:
        return None
    flops = model_flops(m.cfg, m.work)
    return flops / (m.window_s * BF16_FLOPS_PER_S) * 100 if flops else None
