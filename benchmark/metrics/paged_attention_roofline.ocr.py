"""Share of its roofline of decode attention over the paged int8 KV pool,
%: the least time of the window's decode attention (each live slot's K/V
read once, its query and output in bf16; FLOPs of q.K and p.V) at the
published peaks, over the device time of the kernels below."""

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
