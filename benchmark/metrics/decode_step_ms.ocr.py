"""ms of a decode step: the batcher's ``decode_s`` counter (host clock,
each chunk ending in a device-to-host read) over the decode steps the
window ran."""


def read(m):
    steps = len(m.work.steps)
    return m.counters["decode_s"] / steps * 1e3 if steps else None
