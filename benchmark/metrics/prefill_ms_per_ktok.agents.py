"""ms of guided decode's prefill (the batcher's own ``prefill_s``
counter: host clock, each call ending in the top-k ids' read, with the
schema sessions' start) per thousand prompt tokens prefilled in the
window."""


def read(m):
    tokens = sum(m.work.prompts)
    return m.counters["prefill_s"] / tokens * 1e6 if tokens else None
