"""Share of its roofline of the int8-weight products (kernel #5), %: the
least time of the window's decode-shaped int8 products (each step's
projections and lm_head at its live rows; each prefill call's lm_head)
at the published peaks (``work_int8.py``), over the device time of the
kernels below."""

from benchmark.tracing import kernel_seconds
from benchmark.work_int8 import least_seconds_int8

KERNELS = ("int8_mma_kernel", "int8_f32_kernel")


def read(m):
    if m.summary is None or not m.work.steps:
        return None
    seconds = kernel_seconds(m.summary, KERNELS)
    if not seconds:
        return None
    calls = m.ranges.totals.get("prefill_topk", (0.0, 0))[1]
    return least_seconds_int8(m.text, m.work, calls) / seconds * 100
