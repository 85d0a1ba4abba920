"""Share of its roofline of the vision tower's window attention, %: the
windowed blocks of every read encoded (packed qkv in, output out, the
fp32 rotary tables), at the published peaks, over the device time of the
kernels below."""

from benchmark.peaks import least_seconds
from benchmark.tracing import kernel_seconds
from benchmark.work import window_attention

KERNELS = ("window_mma_kernel", "window_f32_kernel")


def read(m):
    if m.summary is None or not m.work.grids:
        return None
    seconds = kernel_seconds(m.summary, KERNELS)
    if not seconds:
        return None
    least = sum(least_seconds(*window_attention(m.cfg.vision, g))
                for g in m.work.grids)
    return least / seconds * 100
