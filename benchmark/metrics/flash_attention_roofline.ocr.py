"""Share of its roofline of flash attention, %: the vision tower's global
blocks of every read encoded and the causal attention of every prompt
prefilled (true lengths, not the padded bucket), at the published peaks,
over the device time of the kernels below."""

from benchmark.peaks import least_seconds
from benchmark.tracing import kernel_seconds
from benchmark.work import flash_prefill, flash_vision

KERNELS = ("flash_wgmma_kernel", "flash_f32_kernel")


def read(m):
    if m.summary is None:
        return None
    seconds = kernel_seconds(m.summary, KERNELS)
    if not seconds:
        return None
    least = sum(least_seconds(*flash_vision(m.cfg.vision, g))
                for g in m.work.grids)
    least += sum(least_seconds(*flash_prefill(m.text, n))
                 for n in m.work.prompts)
    return least / seconds * 100 if least else None
