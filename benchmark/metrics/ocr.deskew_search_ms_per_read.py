"""Host ms per read of deskew's angle search (the min-area-rect search
in Python, after the page's copy to the host): the port's
``preprocess.deskew_angle`` spans over the reads encoded, the
denominator of ``ocr.preprocess_ms_per_read``."""

from benchmark.program_spans import seconds


def read(m):
    reads = len(m.work.grids)
    spent = seconds(m, "preprocess.deskew_angle")
    return spent / reads * 1e3 if reads and spent is not None else None
