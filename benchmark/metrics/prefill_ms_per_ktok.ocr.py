"""ms of the batcher's prefill (its own ``prefill_s`` counter: host
clock, each call ending in a device-to-host read) per thousand prompt
tokens prefilled in the window."""


def read(m):
    tokens = sum(m.work.prompts)
    return m.counters["prefill_s"] / tokens * 1e6 if tokens else None
