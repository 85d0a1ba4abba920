"""Share of its roofline of flash attention in guided decode's prefill,
%: the causal attention of every prompt prefilled at its true length
(``work.py:flash_prefill``), at the published peaks, over the device
time of the kernels below."""

from benchmark.peaks import least_seconds
from benchmark.tracing import kernel_seconds
from benchmark.work import flash_prefill

KERNELS = ("flash_wgmma_kernel", "flash_f32_kernel")


def read(m):
    if m.summary is None or not m.work.prompts:
        return None
    seconds = kernel_seconds(m.summary, KERNELS)
    if not seconds:
        return None
    least = sum(least_seconds(*flash_prefill(m.text, n))
                for n in m.work.prompts)
    return least / seconds * 100
