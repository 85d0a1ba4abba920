"""The decode steps' least time over their time, %: each step reads every
projection and the lm_head once (bf16; the embedding is a row gather) and
each live slot's int8 KV at 3.35 TB/s, against the batcher's
``decode_s``."""

from benchmark.peaks import HBM_BYTES_PER_S
from benchmark.work import decode_floor_seconds


def read(m):
    if not m.work.steps or not m.counters["decode_s"]:
        return None
    floor = decode_floor_seconds(m.text, m.work, HBM_BYTES_PER_S)
    return floor / m.counters["decode_s"] * 100
