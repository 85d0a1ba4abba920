"""Share of its roofline of decode attention over the paged int8 KV pool
in guided decode, %: each top-k or string step's live slots' K/V read
once, their query and output in bf16 (``work.py:paged_attention``, at the
reasoner's 64:8 heads and head_dim 128), over the device time of the
kernels below."""

from benchmark.peaks import least_seconds
from benchmark.tracing import kernel_seconds
from benchmark.work import paged_attention

KERNELS = ("paged_mma_kernel", "paged_f32_kernel")


def read(m):
    if m.summary is None or not m.work.steps:
        return None
    seconds = kernel_seconds(m.summary, KERNELS)
    if not seconds:
        return None
    return least_seconds(*paged_attention(m.text, m.work)) / seconds * 100
